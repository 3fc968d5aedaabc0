// Hand-written Hopper (sm_90a) kernels of the Nussbaumer ("nuss") blind
// rotation, the large-N backend (N = 8192, 16384): K5 recombine_inv (u32
// torus), K6 recombine_inv64 (u64 torus) and K7 rotdig_fwd_nuss (both tori).
// They replace the Pallas kernels of concrete_tpu/core/bootstrap_nuss.py and
// compute the same bits; the plain PyTorch versions beside the wrappers
// (concrete_tpu_torch/core/bootstrap_nuss.py) define what each one returns.
//
// The polynomial of N = L*M coefficients lives as L chunks of M (chunk i,
// position j holds coefficient j*L + i); the 2L-point polynomial transform
// runs over the chunk axis, and every twiddle is a negacyclic rotation of
// the M axis by a multiple of root = M/L. So the M axis splits into `root`
// residue classes (j mod root) that no twiddle mixes: a class is L values
// per chunk, and a rotation by root*e moves position k of a class to
// k + e (mod 2L, negated past L). The kernels keep a group of G classes of
// all 2L chunks in shared memory, which bounds shared memory whatever N:
// [2L][L][G] values. Only the fold of K5 / K6 (times Z = a rotation by 1)
// reads the neighbouring class; the first class of a group takes it from
// the previous group (kept in a side buffer), and class 0, which needs the
// last class, is folded at the end.
//
// A butterfly stage reads two rows and writes two rows whose positions
// differ (the twiddle moves k), so each thread holds its results in
// registers until every thread has read: read phase, barrier, write phase.
//
// Envelope: the wrappers launch these for 2L <= 64 (KERNEL_TWO_L_MAX, every
// chunking best_l picks): L*L*G <= kMaxItems * kThreads holds there.
//
// Torus arithmetic is unsigned (uint32_t, uint64_t, unsigned __int128),
// whose wrap is defined. Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnuss_kernels.so nuss_kernels.cu
// Each extern "C" entry point launches one kernel on the given stream and
// returns a cudaError_t as int.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef unsigned __int128 u128;

constexpr int kSubChunkBits = 7;  // MxuPlan.SUB_CHUNK_BITS
constexpr int kThreads = 1024;
// butterflies a thread holds per stage: 8 of 4- and 8-byte values, 4 of
// 16-byte ones (K6), so that 1024 threads keep them in 64 registers each
constexpr int kMaxItems = 8;
// shared-memory budgets (bytes) of the class-group buffers
constexpr size_t kRecombineSmem = 128 * 1024;
constexpr size_t kRotdigSmem = 200 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ int log2_dev(int v) { return 31 - __clz(v); }

// K5 / K6 store: the low word of v / 2L.
template <typename Out, typename V>
__device__ __forceinline__ Out shifted(V v, int shift) {
  return static_cast<Out>(v >> shift);
}

// K5 recombine_inv (V = uint64_t, Out = uint32_t). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_recombine_inv_pallas.
// K6 recombine_inv64 (V = unsigned __int128, Out = uint64_t). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_recombine_inv_pallas64.
// s [2L, B, (k+1)*lu*M] i32 -> out [k+1, B, L, M] u32 / u64, chunk-major:
//   v[z][c] = sum_j sext(s[z, b, (kj*lu + j)*M + c]) << 8j   (mod 2^64 / 2^128)
//   inverse 2L-point transform over z (twiddles Z^(-root*j*2^st)),
//   fold out_t = c_t + Z*c_{t+L}, then out = low word of (v >> shift).
// The TPU kernels carry these values in u32 word pairs (K5) and 96-bit
// triples emitted as two u32 planes (K6), because the TPU has no 64-bit
// lanes; here they are uint64_t (w' = 32 + shift <= 40 bits) and unsigned
// __int128 (w' = 64 + shift), and K6 writes the int64 words directly.
// One block per (lane b, output polynomial kj).
// Bound on the card: HBM reads of s, lu*4 bytes per (frequency,
// coefficient) against 4 (K5) or 8 (K6) bytes written per output
// coefficient; the transform is log2(2L) adds a value. Design: s is read
// once, in runs of G consecutive words, into the class-group buffer; the
// whole transform and the fold stay in shared memory.
template <typename V, typename Out, int kItems>
__global__ void __launch_bounds__(kThreads) recombine_inv_kernel(
    const int32_t* __restrict__ s, Out* __restrict__ out, int batch, int ks1,
    int lu, int l, int m, int g, int shift) {
  extern __shared__ uint4 smem[];
  V* x = reinterpret_cast<V*>(smem);  // [2L][L][G]
  const int two_l = 2 * l;
  const int root = m / l;
  const int n_grp = root / g;
  const int lg = l * g;
  const int items = l * lg;
  V* side_hi = x + two_l * lg;        // [L][L]: rows L.. of the previous class
  V* side_lo0 = side_hi + l * l;      // [L][L]: rows ..L of class 0, unfolded
  // every extent is a power of two: indices split with shifts and masks
  const int log2l = log2_dev(l);
  const int log2g = log2_dev(g);
  const int log2lg = log2l + log2g;
  const int stages = log2l + 1;
  const int b = blockIdx.x;
  const int kj = blockIdx.y;
  const size_t z_stride = static_cast<size_t>(batch) * ks1 * lu * m;
  const int32_t* s_b = s + (static_cast<size_t>(b) * ks1 + kj) * lu * m;
  Out* out_b = out + (static_cast<size_t>(kj) * batch + b) * l * m;

  for (int grp = 0; grp < n_grp; ++grp) {
    const int r0 = grp * g;
    // limb recombine into the class-group buffer
    for (int idx = threadIdx.x; idx < two_l * lg; idx += blockDim.x) {
      const int z = idx >> log2lg;
      const int k = (idx & (lg - 1)) >> log2g;
      const int rl = idx & (g - 1);
      const int32_t* src = s_b + z * z_stride + k * root + r0 + rl;
      V v = 0;
      for (int j = 0; j < lu; ++j) {
        v += static_cast<V>(static_cast<int64_t>(src[j * m])) << (8 * j);
      }
      x[idx] = v;
    }
    __syncthreads();
    // inverse transform (nussbaumer.inverse_raw): stage st pairs rows
    // u = blk*2h + j and v = u + h; v is rotated by -root*j*2^st
    for (int st = stages - 1; st >= 0; --st) {
      const int half = two_l >> (st + 1);
      const int log2h = stages - 1 - st;
      V ra[kItems], rb[kItems];
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int it = threadIdx.x + q * blockDim.x;
        if (it < items) {
          const int p = it >> log2lg;
          const int k = (it & (lg - 1)) >> log2g;
          const int rl = it & (g - 1);
          const int j = p & (half - 1);
          const int row_u = ((p >> log2h) << (log2h + 1)) + j;
          const int sk = (two_l - ((j << st) & (two_l - 1))) & (two_l - 1);
          const int kk = (k - sk) & (two_l - 1);
          V v = x[((row_u + half) * l + (kk & (l - 1))) * g + rl];
          if (kk >= l) v = V(0) - v;
          const V u = x[(row_u * l + k) * g + rl];
          ra[q] = u + v;
          rb[q] = u - v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kItems; ++q) {
        const int it = threadIdx.x + q * blockDim.x;
        if (it < items) {
          const int p = it >> log2lg;
          const int k = (it & (lg - 1)) >> log2g;
          const int rl = it & (g - 1);
          const int row_u = ((p >> log2h) << (log2h + 1)) + (p & (half - 1));
          x[(row_u * l + k) * g + rl] = ra[q];
          x[((row_u + half) * l + k) * g + rl] = rb[q];
        }
      }
      __syncthreads();
    }
    // fold mod (Y^L - Z): out_t[c] = x_t[c] + x_{t+L}[c - 1], where
    // position -1 is -x_{t+L}[M - 1]; /2L; store
    for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
      const int t = idx >> log2lg;
      const int k = (idx & (lg - 1)) >> log2g;
      const int rl = idx & (g - 1);
      const V lo = x[(t * l + k) * g + rl];
      const int c = k * root + r0 + rl;
      if (r0 + rl > 0) {
        const V hi = rl > 0 ? x[((t + l) * l + k) * g + rl - 1]
                            : side_hi[t * l + k];
        out_b[t * m + c] = shifted<Out>(lo + hi, shift);
      } else if (n_grp == 1) {  // class 0; class root-1 is local g-1
        const V hi = k > 0 ? x[((t + l) * l + k - 1) * g + g - 1]
                           : V(0) - x[((t + l) * l + l - 1) * g + g - 1];
        out_b[t * m + c] = shifted<Out>(lo + hi, shift);
      } else {
        side_lo0[t * l + k] = lo;
      }
    }
    __syncthreads();
    if (n_grp > 1) {  // the last class's high rows, for the next group
      for (int idx = threadIdx.x; idx < l * l; idx += blockDim.x) {
        const int t = idx >> log2l;
        const int k = idx & (l - 1);
        side_hi[idx] = x[((t + l) * l + k) * g + g - 1];
      }
      __syncthreads();
    }
  }
  if (n_grp > 1) {  // class 0 against class root-1
    for (int idx = threadIdx.x; idx < l * l; idx += blockDim.x) {
      const int t = idx >> log2l;
      const int k = idx & (l - 1);
      const V hi = k > 0 ? side_hi[t * l + k - 1] : V(0) - side_hi[t * l + l - 1];
      out_b[t * m + k * root] = shifted<Out>(side_lo0[idx] + hi, shift);
    }
  }
}

// Signed gadget digit of level `lev` (0 = most significant) of one torus
// value: closest_representable + decompose_levels, as K2's emit_digits.
template <typename T>
__device__ __forceinline__ int32_t gadget_digit(T d, int base_log, int level,
                                                int lev) {
  const int non_rep = static_cast<int>(8 * sizeof(T)) - base_log * level;
  if (non_rep > 0) {
    const T msb = (d >> (non_rep - 1)) & T(1);
    d = ((d >> non_rep) + msb) << non_rep;
  }
  T state = d >> non_rep;
  const T mask = (T(1) << base_log) - T(1);
  int32_t digit = 0;
  for (int step = 0; step <= level - 1 - lev; ++step) {
    const T res = state & mask;
    const T st = state >> base_log;
    T carry = ((res - T(1)) | st) & res;
    carry >>= base_log - 1;
    state = st + carry;
    digit = static_cast<int32_t>(
        static_cast<uint32_t>(res - (carry << base_log)));
  }
  return digit;
}

// K7 rotdig_fwd_nuss (T = uint32_t; T = uint64_t for the u64 torus, which
// the JAX package runs as its XLA composition). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_rotdig_fwd_nuss_pallas.
// acc [k+1, B, L, M] u32 / u64 chunk-major, a_hat [B] i32 ->
// d8 [2L, B, R'*M] i8 (frequency-major, z bit-reversed), R' =
// level*n_sub*(k+1), column block ((lev*n_sub + sub)*(k+1) + ki)*M:
// the digits of X^a_hat * acc - acc, zero-padded to 2L chunks, forward
// 2L-point transform (DIF) in wrapping int32, balanced 7-bit sub-digits.
// One block per (lane b, polynomial ki). The row sits in shared memory and
// the rotation is a signed gather from it, as K2's (the TPU kernel's barrel
// of static rolls existed for its compiler); the digits are computed in
// registers, once per level; the transform runs on a class group of
// int32 values in shared memory.
// Bound on the card: HBM traffic, sizeof(T) bytes read per coefficient and
// 2*R'/(k+1) bytes written (the zero padding doubles the digit rows).
// Design: acc is read once, 16 bytes a thread; each warp writes 32
// consecutive d8 bytes of one frequency row.
template <typename T>
__global__ void __launch_bounds__(kThreads) rotdig_fwd_nuss_kernel(
    const T* __restrict__ acc, const int32_t* __restrict__ a_hat,
    int8_t* __restrict__ d8, int batch, int ks1, int l, int m, int g,
    int base_log, int level, int n_sub) {
  extern __shared__ uint4 smem[];
  const int n = l * m;
  T* row = reinterpret_cast<T*>(smem);                 // [L][M]
  uint32_t* x = reinterpret_cast<uint32_t*>(row + n);  // [2L][L][G]
  const int two_l = 2 * l;
  const int root = m / l;
  const int n_grp = root / g;
  const int lg = l * g;
  const int items = l * lg;
  // every extent is a power of two: indices split with shifts and masks
  const int log2l = log2_dev(l);
  const int log2g = log2_dev(g);
  const int log2lg = log2l + log2g;
  const int log2root = log2_dev(root);
  const int stages = log2l + 1;
  const int b = blockIdx.x;
  const int ki = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      acc + (static_cast<size_t>(ki) * batch + b) * n);
  uint4* dst = reinterpret_cast<uint4*>(row);
  const int n16 = n * static_cast<int>(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  const uint32_t a = static_cast<uint32_t>(a_hat[b]);
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * m;

  for (int grp = 0; grp < n_grp; ++grp) {
    const int r0 = grp * g;
    for (int lev = 0; lev < level; ++lev) {
      // digits of the rotation delta at chunk i < L, position j of the
      // group's classes; chunks L..2L-1 are the zero padding
      for (int idx = threadIdx.x; idx < two_l * lg; idx += blockDim.x) {
        const int i = idx >> log2lg;
        uint32_t d = 0;
        if (i < l) {
          const int j = (((idx & (lg - 1)) >> log2g) << log2root) + r0 +
                        (idx & (g - 1));
          const uint32_t t =
              (static_cast<uint32_t>(j * l + i) - a) & wrap;
          const uint32_t sidx = t & static_cast<uint32_t>(n - 1);
          T v = row[(sidx & (l - 1)) * m + (sidx >> log2l)];
          if (t >= static_cast<uint32_t>(n)) v = T(0) - v;
          d = static_cast<uint32_t>(
              gadget_digit<T>(v - row[i * m + j], base_log, level, lev));
        }
        x[idx] = d;
      }
      __syncthreads();
      // forward transform (nussbaumer.forward): stage s pairs rows
      // a = blk*2h + j and b = a + h: a <- a + b, b <- (a - b) * Z^(root*j*2^s)
      for (int s = 0; s < stages; ++s) {
        const int half = two_l >> (s + 1);
        const int log2h = stages - 1 - s;
        uint32_t ra[kMaxItems], rb[kMaxItems];
#pragma unroll
        for (int q = 0; q < kMaxItems; ++q) {
          const int it = threadIdx.x + q * blockDim.x;
          if (it < items) {
            const int p = it >> log2lg;
            const int k = (it & (lg - 1)) >> log2g;
            const int rl = it & (g - 1);
            const int j = p & (half - 1);
            const int row_a = ((p >> log2h) << (log2h + 1)) + j;
            const int row_b = row_a + half;
            const int kk = (k - ((j << s) & (two_l - 1))) & (two_l - 1);
            const int ks = kk & (l - 1);
            uint32_t dv = x[(row_a * l + ks) * g + rl] - x[(row_b * l + ks) * g + rl];
            if (kk >= l) dv = 0u - dv;
            ra[q] = x[(row_a * l + k) * g + rl] + x[(row_b * l + k) * g + rl];
            rb[q] = dv;
          }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kMaxItems; ++q) {
          const int it = threadIdx.x + q * blockDim.x;
          if (it < items) {
            const int p = it >> log2lg;
            const int k = (it & (lg - 1)) >> log2g;
            const int rl = it & (g - 1);
            const int row_a = ((p >> log2h) << (log2h + 1)) + (p & (half - 1));
            x[(row_a * l + k) * g + rl] = ra[q];
            x[((row_a + half) * l + k) * g + rl] = rb[q];
          }
        }
        __syncthreads();
      }
      // balanced 7-bit sub-digits (_split_subdigits, MSB chunk = sub 0)
      for (int idx = threadIdx.x; idx < two_l * lg; idx += blockDim.x) {
        const int z = idx >> log2lg;
        const int c = (((idx & (lg - 1)) >> log2g) << log2root) + r0 +
                      (idx & (g - 1));
        int8_t* out = d8 + (static_cast<size_t>(z) * batch + b) * d8_cols + c;
        int32_t dig = static_cast<int32_t>(x[idx]);
        for (int jj = 0; jj < n_sub; ++jj) {  // jj = 0: least significant
          int32_t e = dig;
          if (jj < n_sub - 1) {
            e = ((dig + (1 << (kSubChunkBits - 1))) &
                 ((1 << kSubChunkBits) - 1)) -
                (1 << (kSubChunkBits - 1));
            dig = static_cast<int32_t>(static_cast<uint32_t>(dig) -
                                       static_cast<uint32_t>(e)) >>
                  kSubChunkBits;
          }
          const int sub = n_sub - 1 - jj;
          out[static_cast<size_t>((lev * n_sub + sub) * ks1 + ki) * m] =
              static_cast<int8_t>(e);
        }
      }
      __syncthreads();
    }
  }
}

int block_threads(int items) {
  return items < kThreads ? (items + 31) / 32 * 32 : kThreads;
}

template <typename V, typename Out, int kItems>
int launch_recombine_inv(const void* s, void* out, int batch, int ks1, int lu,
                         int l, int m, int shift, void* stream) {
  const int root = m / l;
  int g = root;
  while (g > 1 && static_cast<size_t>(2) * l * l * g * sizeof(V) > kRecombineSmem) {
    g >>= 1;
  }
  const int n_grp = root / g;
  const size_t smem = (static_cast<size_t>(2) * l * l * g +
                       (n_grp > 1 ? static_cast<size_t>(2) * l * l : 0)) *
                      sizeof(V);
  const int items = l * l * g;
  const int threads = block_threads(items);
  if (items > kItems * threads || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kern = recombine_inv_kernel<V, Out, kItems>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, ks1), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s), static_cast<Out*>(out), batch, ks1, lu,
      l, m, g, shift);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rotdig_fwd_nuss(const void* acc, const void* a_hat, void* d8,
                           int batch, int ks1, int l, int m, int base_log,
                           int level, int n_sub, void* stream) {
  const int root = m / l;
  const size_t row_bytes = static_cast<size_t>(l) * m * sizeof(T);
  int g = root;
  while (g > 1 && (row_bytes + static_cast<size_t>(2) * l * l * g * 4 > kRotdigSmem ||
                   l * l * g > kMaxItems * kThreads)) {
    g >>= 1;
  }
  const size_t smem = row_bytes + static_cast<size_t>(2) * l * l * g * 4;
  const int items = l * l * g;
  const int threads = block_threads(items);
  if (items > kMaxItems * threads || smem > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto kern = rotdig_fwd_nuss_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, ks1), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<int8_t*>(d8), batch, ks1, l, m, g, base_log, level, n_sub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ctt_recombine_inv(const void* s, void* out, int batch, int ks1, int lu,
                      int l, int m, int shift, void* stream) {
  return launch_recombine_inv<uint64_t, uint32_t, kMaxItems>(s, out, batch, ks1, lu, l, m,
                                                  shift, stream);
}

int ctt_recombine_inv64(const void* s, void* out, int batch, int ks1, int lu,
                        int l, int m, int shift, void* stream) {
  return launch_recombine_inv<u128, uint64_t, kMaxItems / 2>(s, out, batch, ks1, lu, l, m,
                                              shift, stream);
}

int ctt_rotdig_fwd_nuss(const void* acc, const void* a_hat, void* d8,
                        int batch, int ks1, int l, int m, int base_log,
                        int level, int n_sub, void* stream) {
  return launch_rotdig_fwd_nuss<uint32_t>(acc, a_hat, d8, batch, ks1, l, m,
                                          base_log, level, n_sub, stream);
}

int ctt_rotdig_fwd_nuss64(const void* acc, const void* a_hat, void* d8,
                          int batch, int ks1, int l, int m, int base_log,
                          int level, int n_sub, void* stream) {
  return launch_rotdig_fwd_nuss<uint64_t>(acc, a_hat, d8, batch, ks1, l, m,
                                          base_log, level, n_sub, stream);
}

}  // extern "C"
