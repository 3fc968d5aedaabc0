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
// k + e (mod 2L, negated past L). K5 / K6 keep a group of G classes of
// all 2L chunks in shared memory, which bounds shared memory whatever N:
// [2L][L][G] values. Only the fold of K5 / K6 (times Z = a rotation by 1)
// reads the neighbouring class; the first class of a group takes it from
// the previous group (kept in a side buffer), and class 0, which needs the
// last class, is folded at the end. A K5 / K6 butterfly stage reads two
// rows and writes two rows whose positions differ (the twiddle moves k), so
// each thread holds its results in registers until every thread has read:
// read phase, barrier, write phase. K7 holds a class in the registers of L
// lanes instead and rotates with warp shuffles (see its note).
//
// Envelope: the wrappers launch these for 2L <= 64 (KERNEL_TWO_L_MAX, every
// chunking best_l picks): L*L*G <= kMaxItems * kThreads holds there for K5
// / K6; K7 takes L in {2, ..., 32} and M a power of two, a multiple of 4.
//
// Torus arithmetic is unsigned (uint32_t, uint64_t, unsigned __int128),
// whose wrap is defined. Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnuss_kernels.so nuss_kernels.cu
// Each extern "C" entry point launches one kernel on the given stream and
// returns a cudaError_t as int.

#include <algorithm>
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
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kK7Threads = 256;  // K7's block

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

// K7 rotdig_fwd_nuss (T = uint32_t; T = uint64_t for the u64 torus, which
// the JAX package runs as its XLA composition). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_rotdig_fwd_nuss_pallas.
// acc [k+1, B, L, M] u32 / u64 chunk-major, a_hat [B] i32 ->
// d8 [2L, B, R'*M] i8 (frequency-major, z bit-reversed), R' =
// level*n_sub*(k+1), column block ((lev*n_sub + sub)*(k+1) + ki)*M:
// the digits of X^a_hat * acc - acc, zero-padded to 2L chunks, forward
// 2L-point transform (DIF) in wrapping int32, balanced 7-bit sub-digits.
// Bound on the card: HBM traffic, sizeof(T) bytes read per coefficient and
// 2*R'/(k+1) bytes written (the zero padding doubles the digit rows); the
// transform's adds (log2(2L) a value) are a few us at the ALU rate.
// Design. No twiddle mixes residue classes (position j mod root), and
// inside a class a twiddle is a negacyclic rotation of its L positions, so
// a group of L lanes owns one class of one polynomial: lane k holds
// position k*root + r of all 2L rows in registers, and a butterfly's
// rotated operand is one __shfl_sync (width L) from lane (k - e) mod L,
// negated where the index wraps. The transform needs no shared memory and
// no barrier; stage 0 pairs each row with a zero row, so it is a copy and a
// rotation. Before it, one coalesced pass gathers the rotation from global
// memory (for a chunk the source positions are consecutive) and rounds each
// coefficient once; the decomposition state stays in shared memory,
// class-major, and each level takes one more digit step from it, so the
// digit work is O(level), not O(level^2). Each lane stages its 2L
// sub-digit bytes in shared memory as words (four rows z a word, one row of
// words a lane); the stores to d8 take 4 x 4 byte blocks of four lanes'
// rows and transpose them with __byte_perm, so every store writes 4
// positions of one frequency row and a warp writes whole runs of it. A
// block takes max(1, 256/M) polynomials (the TFHE_LIB ring, M = 32: 8 a
// block), so the small rings fill the card too; 2 barriers a level and
// sub-digit pass.
template <int L>
struct Log2 {
  static constexpr int value = L <= 1 ? 0 : 1 + Log2<L / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// Byte transpose of a 4 x 4 block: out[j] holds byte j of a, b, c, d.
__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140);
  const uint32_t t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);  // a0 b0 c0 d0
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The low bytes of a, b, c, d in one word (a in byte 0).
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Stages s >= 1 of K7's transform on the 2L rows a lane holds: rows
// a = blk*2h + jj and a + h; a <- a + b, b <- (a - b) * Z^(root*jj*2^s), a
// rotation of the class by e = jj*2^s < L. One flat loop per stage, the
// stage a template argument, so every row index is a constant and x stays
// in registers.
template <int L, int S>
__device__ __forceinline__ void dif_stages(uint32_t (&x)[2 * L], int k) {
  constexpr int kHalf = (2 * L) >> (S + 1);
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int jj = t % kHalf;
    const int ia = (t / kHalf) * 2 * kHalf + jj;
    const int ib = ia + kHalf;
    const uint32_t sum = x[ia] + x[ib];
    const uint32_t dif = x[ia] - x[ib];
    const int e = jj << S;
    x[ia] = sum;
    if (e == 0) {
      x[ib] = dif;
    } else {
      const uint32_t v = __shfl_sync(0xffffffffu, dif, (k - e) & (L - 1), L);
      x[ib] = k < e ? 0u - v : v;
    }
  }
  if constexpr (S < Log2<L>::value) dif_stages<L, S + 1>(x, k);
}

template <typename T, typename S, int L>
__global__ void __launch_bounds__(kK7Threads) rotdig_fwd_nuss_kernel(
    const T* __restrict__ acc, const int32_t* __restrict__ a_hat,
    int8_t* __restrict__ d8, int batch, int ks1, int m, int polys,
    int stride, int base_log, int level, int n_sub, int passes) {
  constexpr int kTwoL = 2 * L;
  constexpr int kLog2L = Log2<L>::value;
  extern __shared__ uint4 smem[];
  const int n = L * m;
  const int log2m = log2_dev(m);
  const int log2n = log2m + kLog2L;
  const int root = m >> kLog2L;
  const int log2root = log2m - kLog2L;
  const int staged = passes == 1 ? n_sub : 1;  // sub-digit planes staged
  // a staged row holds one lane's 2L sub-digit bytes (class-major rows
  // r*L + k); an odd word pitch keeps the lanes' word stores on distinct
  // banks
  constexpr int kPitch = L == 2 ? 1 : L / 2 + 1;
  long long* base_s = reinterpret_cast<long long*>(smem);  // d8 offset of (b, ki)
  int32_t* a_s = reinterpret_cast<int32_t*>(base_s + polys);
  S* state = reinterpret_cast<S*>(
      smem + (static_cast<size_t>(polys) * 12 + 15) / 16);  // [P][L][root][stride]
  uint32_t* stage = reinterpret_cast<uint32_t*>(
      state + static_cast<size_t>(polys) * m * stride);  // [P][staged][M][pitch]
  const int pidx0 = blockIdx.x * polys;
  const int n_polys = ks1 * batch;
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * m;
  for (int p = threadIdx.x; p < polys; p += blockDim.x) {
    const int pidx = pidx0 + p;
    const int ki = pidx / batch;
    const int b = pidx - ki * batch;
    const bool ok = pidx < n_polys;
    a_s[p] = ok ? a_hat[b] : 0;
    base_s[p] = ok ? static_cast<long long>(b) * d8_cols +
                         static_cast<long long>(ki) * m
                   : -1;
  }
  __syncthreads();

  // rotation delta of every coefficient, rounded to its top base_log*level
  // bits: state[p][i][j mod root][j / root] (`stride` >= L words a class,
  // chosen by the launcher to keep these writes and the digit steps' reads
  // on distinct banks); 8 gathers a thread in flight
  const int non_rep = static_cast<int>(8 * sizeof(T)) - base_log * level;
  const int per = polys * n / blockDim.x;  // coefficients a thread
  for (int q0 = 0; q0 < per; q0 += 8) {
    T rot[8], cur[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = threadIdx.x + (q0 + q) * blockDim.x;
      const int p = idx >> log2n;
      if (q0 + q < per && pidx0 + p < n_polys) {
        const T* row = acc + static_cast<size_t>(pidx0 + p) * n;
        const uint32_t t =
            (static_cast<uint32_t>((idx & (m - 1)) * L + ((idx >> log2m) & (L - 1))) -
             static_cast<uint32_t>(a_s[p])) &
            static_cast<uint32_t>(2 * n - 1);
        const uint32_t src = t & static_cast<uint32_t>(n - 1);
        rot[q] = __ldg(row + (src & (L - 1)) * m + (src >> kLog2L));
        if (t >= static_cast<uint32_t>(n)) rot[q] = T(0) - rot[q];
        cur[q] = __ldg(row + (idx & (n - 1)));
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int idx = threadIdx.x + (q0 + q) * blockDim.x;
      const int p = idx >> log2n;
      if (q0 + q < per && pidx0 + p < n_polys) {
        const int i = (idx >> log2m) & (L - 1);
        const int j = idx & (m - 1);
        T d = rot[q] - cur[q];
        if (non_rep > 0) {
          const T msb = (d >> (non_rep - 1)) & T(1);
          d = ((d >> non_rep) + msb) << non_rep;
        }
        state[((static_cast<size_t>(p) * L + i) * root + (j & (root - 1))) *
                  stride + (j >> log2root)] = static_cast<S>(d >> non_rep);
      }
    }
  }
  __syncthreads();

  const int k = threadIdx.x & (L - 1);
  const int group = threadIdx.x >> kLog2L;
  const int groups = blockDim.x >> kLog2L;
  const int units_per_group = polys * root / groups;  // the same for all
  const S mask = (S(1) << base_log) - S(1);
  const int log2c4 = log2m - 2;  // position quads a row: M/4
  const size_t z_stride = static_cast<size_t>(batch) * d8_cols;
  for (int step = 0; step < level; ++step) {
    const int lev = level - 1 - step;
    for (int pass = 0; pass < passes; ++pass) {
      const bool keep = pass == passes - 1 && step < level - 1;
      for (int it = 0; it < units_per_group; ++it) {
        const int u = group + it * groups;
        const int p = u >> log2root;
        const int r = u & (root - 1);
        S* col = state + ((static_cast<size_t>(p) * L * root + r) * stride + k);
        // one decomposition step: the digit of level lev (K2's emit_digits)
        uint32_t x[kTwoL];
#pragma unroll
        for (int i = 0; i < L; ++i) {
          S* sp = col + static_cast<size_t>(i) * root * stride;
          const S st = *sp;
          const S res = st & mask;
          const S hi = st >> base_log;
          S carry = ((res - S(1)) | hi) & res;
          carry >>= base_log - 1;
          if (keep) *sp = hi + carry;
          x[i] = static_cast<uint32_t>(res - (carry << base_log));
        }
        // forward transform (nussbaumer.forward); stage 0 against the zero
        // rows: row L+i = row i * Z^(root*i)
        x[L] = x[0];
#pragma unroll
        for (int i = 1; i < L; ++i) {
          const uint32_t t = __shfl_sync(0xffffffffu, x[i], (k - i) & (L - 1), L);
          x[L + i] = k < i ? 0u - t : t;
        }
        dif_stages<L, 1>(x, k);
        // balanced 7-bit sub-digits (_split_subdigits, MSB chunk = sub 0),
        // four rows z a word, into this lane's staged row
        uint32_t* srow = stage + (static_cast<size_t>(p) * staged * m + r * L + k) * kPitch;
        for (int jj = 0; jj < n_sub; ++jj) {  // jj = 0: least significant
          const int sub = n_sub - 1 - jj;
          const bool store = passes == 1 || sub == pass;
          uint32_t* dst = srow + static_cast<size_t>(passes == 1 ? sub : 0) * m * kPitch;
          if (jj == n_sub - 1) {  // the top chunk is what is left
#pragma unroll
            for (int z4 = 0; z4 < kTwoL / 4; ++z4) {
              const uint32_t word = pack4(x[4 * z4], x[4 * z4 + 1],
                                          x[4 * z4 + 2], x[4 * z4 + 3]);
              if (store) dst[z4] = word;
            }
          } else {
#pragma unroll
            for (int z4 = 0; z4 < kTwoL / 4; ++z4) {
              uint32_t e[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int32_t dig = static_cast<int32_t>(x[4 * z4 + q]);
                const int32_t lo = ((dig + (1 << (kSubChunkBits - 1))) &
                                    ((1 << kSubChunkBits) - 1)) -
                                   (1 << (kSubChunkBits - 1));
                x[4 * z4 + q] = static_cast<uint32_t>(
                    static_cast<int32_t>(static_cast<uint32_t>(dig) -
                                         static_cast<uint32_t>(lo)) >>
                    kSubChunkBits);
                e[q] = static_cast<uint32_t>(lo);
              }
              const uint32_t word = pack4(e[0], e[1], e[2], e[3]);
              if (store) dst[z4] = word;
            }
          }
        }
      }
      __syncthreads();
      // d8 rows from the staged ones: a thread reads the words of rows
      // z..z+3 of four positions c..c+3 and transposes them (4 x 4 bytes),
      // so each store is 4 positions of one row and a warp writes whole
      // runs of a row (128 contiguous bytes at M >= 128)
      const int total = polys * staged * (kTwoL / 4) << log2c4;
      for (int w = threadIdx.x; w < total; w += blockDim.x) {
        const int c4 = w & ((1 << log2c4) - 1);
        const int zr = w >> log2c4;
        const int z4 = zr & (kTwoL / 4 - 1);
        const int ps = zr / (kTwoL / 4);  // p * staged + sl
        const int p = ps / staged;
        const long long base = base_s[p];
        if (base < 0) continue;
        const int sub = passes == 1 ? ps - p * staged : pass;
        const uint32_t* rows = stage + static_cast<size_t>(ps) * m * kPitch + z4;
        uint32_t v[4], o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 4 * c4 + q;
          v[q] = rows[((c & (root - 1)) * L + (c >> log2root)) * kPitch];
        }
        transpose4x4(v[0], v[1], v[2], v[3], o);
        int8_t* dst = d8 + base + static_cast<size_t>((lev * n_sub + sub) * ks1) * m +
                      4 * c4 + 4 * z4 * z_stride;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(dst + j * z_stride) = o[j];
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

int log2_int(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Words a class of the K7 state takes (>= L): the stride that keeps two
// access patterns of a warp on the fewest shared banks: the coalesced
// writes of its 32 coefficients (class j mod root, place j / root), and the
// digit steps' reads, one class per L lanes (weighted by their count).
int state_stride(int l, int root) {
  int best = l, best_cost = 1 << 30;
  for (int s = l; s < l + 32; ++s) {
    int write[32] = {0}, read[32] = {0}, cost_w = 0, cost_r = 0;
    for (int j = 0; j < 32; ++j) {
      cost_w = std::max(cost_w, ++write[((j % root) * s + j / root) % 32]);
      cost_r = std::max(cost_r, ++read[(((j / l) % root) * s + j % l) % 32]);
    }
    const int cost = cost_w + 4 * cost_r;
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T, typename S, int L>
int launch_k7(const void* acc, const void* a_hat, void* d8, int batch,
              int ks1, int m, int base_log, int level, int n_sub,
              void* stream) {
  const int polys = m >= kK7Threads ? 1 : kK7Threads / m;
  const int threads = polys * m < kK7Threads ? polys * m : kK7Threads;
  // per instantiation, once: the state stride of each root (a power of
  // two) and the shared-memory limit, so that a launch costs the host
  // nothing more than the launch
  static int strides[32] = {0};
  static bool raised = false;
  const int log2root = log2_int(m / L);
  if (strides[log2root] == 0) strides[log2root] = state_stride(L, m / L);
  const int stride = strides[log2root];
  const size_t fixed = (static_cast<size_t>(polys) * 12 + 15) / 16 * 16 +
                       static_cast<size_t>(polys) * m * stride * sizeof(S);
  const size_t rows = static_cast<size_t>(polys) * m * (L == 2 ? 1 : L / 2 + 1) * 4;
  int passes = 1;
  size_t smem = fixed + rows * n_sub;
  if (smem > kSmemMax) {  // stage one sub-digit plane at a time
    passes = n_sub;
    smem = fixed + rows;
  }
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = rotdig_fwd_nuss_kernel<T, S, L>;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int n_polys = ks1 * batch;
  kern<<<(n_polys + polys - 1) / polys, threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<int8_t*>(d8), batch, ks1, m, polys, stride, base_log, level,
      n_sub, passes);
  return static_cast<int>(cudaGetLastError());
}

// The decomposition state has base_log*level bits: a u32 word holds it
// unless the u64 torus takes more than 32.
template <typename T, int L>
int launch_k7_state(const void* acc, const void* a_hat, void* d8, int batch,
                    int ks1, int m, int base_log, int level, int n_sub,
                    void* stream) {
  if (sizeof(T) == 8 && base_log * level > 32) {
    return launch_k7<T, uint64_t, L>(acc, a_hat, d8, batch, ks1, m, base_log,
                                     level, n_sub, stream);
  }
  return launch_k7<T, uint32_t, L>(acc, a_hat, d8, batch, ks1, m, base_log,
                                   level, n_sub, stream);
}

template <typename T>
int launch_rotdig_fwd_nuss(const void* acc, const void* a_hat, void* d8,
                           int batch, int ks1, int l, int m, int base_log,
                           int level, int n_sub, void* stream) {
  if (base_log < 1 || base_log >= 32 ||
      base_log * level > static_cast<int>(8 * sizeof(T)) || m % 4 || m < l ||
      (m & (m - 1)) || m % l) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (l) {
    case 2:
      return launch_k7_state<T, 2>(acc, a_hat, d8, batch, ks1, m, base_log,
                                   level, n_sub, stream);
    case 4:
      return launch_k7_state<T, 4>(acc, a_hat, d8, batch, ks1, m, base_log,
                                   level, n_sub, stream);
    case 8:
      return launch_k7_state<T, 8>(acc, a_hat, d8, batch, ks1, m, base_log,
                                   level, n_sub, stream);
    case 16:
      return launch_k7_state<T, 16>(acc, a_hat, d8, batch, ks1, m, base_log,
                                    level, n_sub, stream);
    case 32:
      return launch_k7_state<T, 32>(acc, a_hat, d8, batch, ks1, m, base_log,
                                    level, n_sub, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
