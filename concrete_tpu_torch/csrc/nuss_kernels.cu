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
// k + e (mod 2L, negated past L). Both kernels hold a class in the
// registers of L lanes (lane k: position k*root + r of its rows) and rotate
// with warp shuffles. Only the fold of K5 / K6 (times Z = a rotation by 1)
// reads the neighbouring class (class 0 reads class root-1, one position
// down); see K5's note for how it reaches it.
//
// Envelope: the wrappers launch these for 2L <= 64 (KERNEL_TWO_L_MAX, every
// chunking best_l picks): K5 / K6 and K7 take L in {2, ..., 32} and M a
// power of two; K5 / K6 M up to 8192 at L <= 8, 4096 at L = 16 (and K6 at
// L = 32), 2048 for K5 at L = 32 (every N <= 16384 at every L); K7 M a
// multiple of 4.
//
// Torus arithmetic is unsigned (uint32_t, uint64_t, a 96-bit pair), whose
// wrap is defined. Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnuss_kernels.so nuss_kernels.cu
// Each extern "C" entry point launches one kernel on the given stream and
// returns a cudaError_t as int.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

typedef unsigned __int128 u128;

constexpr int kSubChunkBits = 7;  // MxuPlan.SUB_CHUNK_BITS
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kK7Threads = 256;  // K7's block
// K5 / K6: a block's threads at L = 32 (2L a class slot; K5 two blocks an
// SM at 128 registers a thread, K6 one block of 512 at 128), the rows
// whose limbs a thread loads at once, the largest cluster
// (tools/k56_sweep.py times the alternatives)
constexpr int kRecThreads = 256;
constexpr int kRecThreads64 = 512;
constexpr int kRecBatch = 4;
constexpr int kClusterMax = 16;

__device__ __forceinline__ int log2_dev(int v) { return 31 - __clz(v); }

template <int L>
struct Log2 {
  static constexpr int value = L <= 1 ? 0 : 1 + Log2<L / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// K6's value: exact mod 2^96 (the kernel needs 2^(64 + shift) <= 2^70),
// one 64-bit and one 32-bit word. K5's is a uint64_t (it needs 2^38). The
// u128 forms below are what tools/k56_sweep.py measures U96 against.
struct U96 {
  uint64_t lo;
  uint32_t hi;
};
using K6Value = U96;

__device__ __forceinline__ U96 operator+(U96 a, U96 b) {
  U96 r;
  r.lo = a.lo + b.lo;
  r.hi = a.hi + b.hi + (r.lo < a.lo ? 1u : 0u);
  return r;
}
__device__ __forceinline__ U96 operator-(U96 a, U96 b) {
  U96 r;
  r.lo = a.lo - b.lo;
  r.hi = a.hi - b.hi - (a.lo < b.lo ? 1u : 0u);
  return r;
}
__device__ __forceinline__ U96 neg(U96 v) { return U96{0, 0} - v; }
__device__ __forceinline__ uint64_t neg(uint64_t v) { return 0 - v; }
__device__ __forceinline__ u128 neg(u128 v) { return 0 - v; }

// v = sum_j sext(w[j]) << 8j, the limb recombine
template <int LU>
__device__ __forceinline__ void recombine(const int32_t (&w)[LU], uint64_t& v) {
  v = 0;
#pragma unroll
  for (int j = 0; j < LU; ++j) {
    v += static_cast<uint64_t>(static_cast<int64_t>(w[j])) << (8 * j);
  }
}
template <int LU>
__device__ __forceinline__ void recombine(const int32_t (&w)[LU], u128& v) {
  v = 0;
#pragma unroll
  for (int j = 0; j < LU; ++j) {
    v += static_cast<u128>(static_cast<__int128>(w[j])) << (8 * j);
  }
}
// K6's nine limbs as a + b * 2^32 + w[8] * 2^64: limbs 0-3 and 4-7 sum
// exactly in int64 (|a|, |b| < 2^57), one carry joins them
template <int LU>
__device__ __forceinline__ void recombine(const int32_t (&w)[LU], U96& v) {
  static_assert(LU == 9, "K6 recombines 9 limbs");
  int64_t a = 0, b = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a += static_cast<int64_t>(w[j]) * (int64_t{1} << (8 * j));
    b += static_cast<int64_t>(w[j + 4]) * (int64_t{1} << (8 * j));
  }
  v.lo = static_cast<uint64_t>(a) + (static_cast<uint64_t>(b) << 32);
  v.hi = static_cast<uint32_t>(a >> 63) + static_cast<uint32_t>(b >> 32) +
         static_cast<uint32_t>(w[8]) +
         (v.lo < static_cast<uint64_t>(a) ? 1u : 0u);
}

// the stored word: the low 32 / 64 bits of v >> shift (0 < shift < 32)
__device__ __forceinline__ uint64_t shifted(uint64_t v, int shift) {
  return v >> shift;
}
__device__ __forceinline__ uint64_t shifted(U96 v, int shift) {
  return (v.lo >> shift) | (static_cast<uint64_t>(v.hi) << (64 - shift));
}
__device__ __forceinline__ uint64_t shifted(u128 v, int shift) {
  return static_cast<uint64_t>(v >> shift);
}

template <int W>
__device__ __forceinline__ uint64_t shfl(uint64_t v, int src) {
  return __shfl_sync(0xffffffffu, static_cast<unsigned long long>(v), src, W);
}
template <int W>
__device__ __forceinline__ U96 shfl(U96 v, int src) {
  return U96{shfl<W>(v.lo, src), __shfl_sync(0xffffffffu, v.hi, src, W)};
}
template <int W>
__device__ __forceinline__ u128 shfl(u128 v, int src) {
  const uint64_t lo = shfl<W>(static_cast<uint64_t>(v), src);
  const uint64_t hi = shfl<W>(static_cast<uint64_t>(v >> 64), src);
  return (static_cast<u128>(hi) << 64) | lo;
}

// Values in shared memory: a region of n values; U96 as a plane of n
// 64-bit words and one of n 32-bit words (12 bytes a value).
template <typename V>
struct ValueBytes {
  static constexpr int value = sizeof(V);
};
template <>
struct ValueBytes<U96> {
  static constexpr int value = 12;
};
// the bytes of a value in its first plane
template <typename V>
struct Plane0Bytes {
  static constexpr int value = sizeof(V);
};
template <>
struct Plane0Bytes<U96> {
  static constexpr int value = 8;
};
__device__ __forceinline__ void put(char* r, int, int i, uint64_t v) {
  reinterpret_cast<uint64_t*>(r)[i] = v;
}
__device__ __forceinline__ void put(char* r, int, int i, u128 v) {
  reinterpret_cast<u128*>(r)[i] = v;
}
__device__ __forceinline__ void put(char* r, int n, int i, U96 v) {
  reinterpret_cast<uint64_t*>(r)[i] = v.lo;
  reinterpret_cast<uint32_t*>(r + 8 * static_cast<size_t>(n))[i] = v.hi;
}
__device__ __forceinline__ void get(const char* r, int, int i, uint64_t& v) {
  v = reinterpret_cast<const uint64_t*>(r)[i];
}
__device__ __forceinline__ void get(const char* r, int, int i, u128& v) {
  v = reinterpret_cast<const u128*>(r)[i];
}
__device__ __forceinline__ void get(const char* r, int n, int i, U96& v) {
  v.lo = reinterpret_cast<const uint64_t*>(r)[i];
  v.hi = reinterpret_cast<const uint32_t*>(r + 8 * static_cast<size_t>(n))[i];
}

// Stages half = H, 2H, ..., L/2 of the inverse transform
// (nussbaumer.inverse_raw) on the L rows a lane holds: rows u = blk*2H + j
// and v = u + H; v is rotated by -root*e, e = j*L/H < L, which takes
// position k + e (negated past L): one __shfl_sync of width L. One flat
// loop a stage, the stage a template argument, so every row index is a
// constant and x stays in registers.
template <typename V, int L, int H>
__device__ __forceinline__ void inv_stages(V (&x)[L], int k) {
  if constexpr (H < L) {
#pragma unroll
    for (int t = 0; t < L / 2; ++t) {
      const int j = t % H;
      const int iu = (t / H) * 2 * H + j;
      const int iv = iu + H;
      const int e = j * (L / H);
      V v = x[iv];
      if (e != 0) {
        v = shfl<L>(v, (k + e) & (L - 1));
        if (k + e >= L) v = neg(v);
      }
      const V u = x[iu];
      x[iu] = u + v;
      x[iv] = u - v;
    }
    inv_stages<V, L, 2 * H>(x, k);
  }
}

// K5 / K6's most threads a block (the launch bound): 2L lanes a class slot,
// kRecThreads (K5) or kRecThreads64 (K6) at L = 32
template <typename V, int L>
struct RecMaxThreads {
  static constexpr int value =
      L >= 32 ? (sizeof(V) > 8 ? kRecThreads64 : kRecThreads) : (L == 16 ? 512 : 1024);
};

// K5 recombine_inv (V = uint64_t, Out = uint32_t, LU = 5 limbs). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_recombine_inv_pallas.
// K6 recombine_inv64 (V = U96, Out = uint64_t, LU = 9). Replaces
// concrete_tpu/core/bootstrap_nuss.py:_recombine_inv_pallas64.
// s [2L, B, (k+1)*LU*M] i32 -> out [k+1, B, L, M] u32 / u64, chunk-major:
//   v[z][c] = sum_j sext(s[z, b, (kj*LU + j)*M + c]) << 8j  (exact mod 2^w',
//   w' = bits + shift), the inverse 2L-point transform over z (twiddles
//   Z^(-root*j*2^st)), the fold out_t = c_t + Z*c_{t+L}, then the low word
//   of v >> shift. The TPU kernels carry these values in u32 word pairs (K5)
//   and 96-bit triples (K6); here a uint64_t and a 64 + 32-bit pair.
// Bound on the card: HBM reads of s, 4*LU bytes a frequency value against 4
// (K5) or 8 (K6) bytes written an output coefficient; the integer work
// (~LU + 6*log2(2L) word operations a value) is below it.
// Design.
// - A block owns g classes of `polys` whole polynomials (g = root; several
//   polynomials a block at small root: 4 on the TFHE_LIB ring, M = 32), or
//   g = root / C classes of one polynomial, the C blocks of a thread block
//   cluster sharing it: the first class of a block reads its neighbour's
//   fold rows from the previous block's shared memory (DSMEM). No block
//   loops over class groups and nothing is carried between them.
// - Gather: the M words of one (row, limb) are contiguous and a block's
//   classes are runs of g words of them. Every thread loads one position of
//   every other row, coalesced, kRecBatch rows' limbs in flight at once,
//   recombines them in registers and writes the value class-major into
//   shared memory, X [2L][slot][stride] (8 / 12 bytes a value, not the 4*LU
//   of the limbs). One barrier. The loads run under the transform of the
//   other block of an SM (K5: two blocks an SM; K6 takes one of 512
//   threads, which measured faster); tools/k56_sweep.py splits the time.
// - Transform in registers: a class slot is 2L lanes; lane k of the low
//   half takes position k of rows 0..L-1 from X, the high half rows
//   L..2L-1 (L values a lane). Stages half = 1..L/2 never leave a half:
//   shuffles only, no barrier.
// - Last stage and fold in X: each half writes back what the other needs
//   (over the words it alone read), does half of the last stage (t < L/2,
//   t >= L/2), keeps c_t and writes c_{t+L} over what it alone read; after a
//   (cluster) barrier the fold reads c_{t+L} of the neighbouring class.
// - Stores: the folded words are staged class-major over the rows L..2L-1
//   of X and leave in 16-byte stores of runs of out.
template <typename V, typename Out, int L, int LU>
__global__ void __launch_bounds__(RecMaxThreads<V, L>::value)
    recombine_inv_kernel(const int32_t* __restrict__ s, Out* __restrict__ out,
                         int batch, int ks1, int m, int g, int polys,
                         int stride, int cluster, int shift) {
  extern __shared__ uint4 smem[];
  char* x_s = reinterpret_cast<char*>(smem);
  constexpr int kLog2L = Log2<L>::value;
  constexpr int kBatch = L < kRecBatch ? L : kRecBatch;
  const int root = m >> kLog2L;
  const int log2g = log2_dev(g);
  const int gl = g << kLog2L;
  const int slots = g * polys;
  const int threads = 2 * L * slots;
  const int n_polys = ks1 * batch;
  const int q = blockIdx.x % cluster;  // rank in the cluster
  const int r0 = q * g;
  const int tid = threadIdx.x;
  const int n_x = 2 * L * slots * stride;  // X's values
  auto xi = [&](int z, int sl, int kk) { return (z * slots + sl) * stride + kk; };

  namespace cg = cooperative_groups;
  cg::cluster_group blocks = cg::this_cluster();
  const int pg = blockIdx.x / cluster;
  // gather: thread tid takes word qw of the runs of polynomial pw, rows
  // hw, hw + 2, ... (threads = 2 * polys * g * L)
  {
    const int qw = tid & (gl - 1);
    const int pw = (tid >> (kLog2L + log2g)) % polys;
    const int hw = tid / (gl * polys);
    const int pidx = pg * polys + pw;
    const bool valid = pidx < n_polys;
    const int kj = pidx / batch;
    const size_t z_stride = static_cast<size_t>(batch) * ks1 * LU * m;
    const int32_t* src =
        s + hw * z_stride +
        (static_cast<size_t>(pidx - kj * batch) * ks1 + kj) * LU * m +
        (qw >> log2g) * root + r0 + (qw & (g - 1));
    const int slot_w = pw * g + (qw & (g - 1));
    const int k_w = qw >> log2g;
    auto rows = [&](int i0) {  // kBatch rows: their limbs, then the values
      int32_t w[kBatch][LU];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int j = 0; j < LU; ++j) {
          w[b][j] = valid ? __ldg(src + 2 * (i0 + b) * z_stride + j * m) : 0;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        V v;
        recombine<LU>(w[b], v);
        put(x_s, n_x, xi(2 * (i0 + b) + hw, slot_w, k_w), v);
      }
    };
    // unrolled, the next rows' loads start before this batch's recombine:
    // faster on K5, slower on K6 (more registers; tools/k56_sweep.py)
    if constexpr (LU < 9) {
#pragma unroll
      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);
    } else {
#pragma unroll 1
      for (int i0 = 0; i0 < L; i0 += kBatch) rows(i0);
    }
  }
  __syncthreads();

  const int k = tid & (L - 1);
  const int half = (tid >> kLog2L) & 1;
  const int slot = tid >> (kLog2L + 1);
  const int p = slot >> log2g;
  const int rl = slot & (g - 1);
  V x[L];
#pragma unroll
  for (int i = 0; i < L; ++i) get(x_s, n_x, xi(half * L + i, slot, k), x[i]);
  inv_stages<V, L, 1>(x, k);

  // last stage (half = L): c_t = a_t + b_t', c_{t+L} = a_t - b_t', b_t' =
  // row L + t rotated by -root*t. A lane writes only words it alone read.
  if (half == 0) {
#pragma unroll
    for (int t = L / 2; t < L; ++t) put(x_s, n_x, xi(t, slot, k), x[t]);
  } else {
#pragma unroll
    for (int t = 0; t < L; ++t) put(x_s, n_x, xi(L + t, slot, k), x[t]);
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int t = 0; t < L / 2; ++t) {
      V b;
      get(x_s, n_x, xi(L + t, slot, (k + t) & (L - 1)), b);
      if (k + t >= L) b = neg(b);
      const V a = x[t];
      x[t] = a + b;
      put(x_s, n_x, xi(t, slot, k), a - b);
    }
  } else {
#pragma unroll
    for (int t = L / 2; t < L; ++t) {
      V a, b;
      get(x_s, n_x, xi(t, slot, k), a);
      get(x_s, n_x, xi(L + t, slot, (k + t) & (L - 1)), b);
      if (k + t >= L) b = neg(b);
      x[t] = a + b;
      put(x_s, n_x, xi(t, slot, k), a - b);
    }
  }
  if (cluster > 1) {
    blocks.sync();
  } else {
    __syncthreads();
  }

  // fold: out_t = c_t + Z * c_{t+L}: the previous class (slot rl - 1, or
  // the previous block's last slot), class 0 from class root - 1 one
  // position down, negated where it wraps
  const char* nb = x_s;
  int nb_slot = slot - 1;
  bool wrap = false;
  if (rl == 0) {
    nb_slot = p * g + g - 1;
    wrap = q == 0;
    if (cluster > 1) {
      nb = blocks.map_shared_rank(x_s, (q + cluster - 1) % cluster);
    }
  }
  const int kk = wrap ? ((k - 1) & (L - 1)) : k;
  const bool negate = wrap && k == 0;
  // [polys][L][g][stride] Out words over the first plane of rows L..2L-1
  Out* o = reinterpret_cast<Out*>(x_s + static_cast<size_t>(n_x / 2) *
                                            Plane0Bytes<V>::value);
  const int o_row = (p * L * g + rl) * stride + k;
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int t = i + (half ? L / 2 : 0);
    V h;
    get(nb, n_x, xi(t, nb_slot, kk), h);
    if (negate) h = neg(h);
    const V c = half ? x[i + L / 2] : x[i];
    o[o_row + t * g * stride] = static_cast<Out>(shifted(c + h, shift));
  }
  __syncthreads();

  // stores: runs of g words of out (all M when the block owns its
  // polynomials whole), 16 bytes a store where a run holds them
  constexpr int kVec = 16 / sizeof(Out);
  const int words = polys * L * gl;
  const bool vec = (cluster == 1 || (g % kVec) == 0) && (m % kVec) == 0;
  const int step = vec ? kVec : 1;
  for (int w = tid * step; w < words; w += threads * step) {
    const int qq = w & (gl - 1);
    const int pt = w >> (kLog2L + log2g);  // p * L + t
    const int pidx = pg * polys + (pt >> kLog2L);
    if (pidx >= n_polys) continue;
    Out* dst = out + (static_cast<size_t>(pidx) * L + (pt & (L - 1))) * m +
               (qq >> log2g) * root + r0 + (qq & (g - 1));
    const Out* row = o + static_cast<size_t>(pt) * g * stride;
    if (vec) {
      union {
        Out w[kVec];
        uint4 v;
      } pack;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int qe = qq + e;
        pack.w[e] = row[(qe & (g - 1)) * stride + (qe >> log2g)];
      }
      *reinterpret_cast<uint4*>(dst) = pack.v;
    } else {
      *dst = row[(qq & (g - 1)) * stride + (qq >> log2g)];
    }
  }
  if (cluster > 1) blocks.sync();  // the next block has read our c_{t+L}
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

int log2_int(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// K5 / K6 geometry: g classes a block, `polys` polynomials a block (when
// the block owns them whole), `cluster` blocks a polynomial otherwise.
template <typename V, typename Out, int L, int LU>
int launch_recombine_l(const void* s, void* out, int batch, int ks1, int m,
                       int shift, void* stream) {
  constexpr int kMaxThreads = RecMaxThreads<V, L>::value;
  const int root = m / L;
  const int slots = std::max(1, (sizeof(V) > 8 ? kRecThreads64 : kRecThreads) / (2 * L));
  int g = std::min(root, slots);
  int cluster = root / g;
  if (cluster > kClusterMax) {
    cluster = kClusterMax;
    g = root / kClusterMax;
  }
  const int polys = cluster == 1 ? slots / g : 1;
  const int threads = 2 * L * g * polys;
  if (threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // X: 2L rows of `slots` classes, L + 1 words a class (odd: the lanes of
  // a warp read one class, consecutive words)
  const int stride = L + 1;
  const size_t smem = static_cast<size_t>(2) * L * g * polys * stride *
                      ValueBytes<V>::value;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidConfiguration);
  static bool raised = false;  // per instantiation, once
  auto kern = recombine_inv_kernel<V, Out, L, LU>;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemMax));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int groups = (ks1 * batch + polys - 1) / polys;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const int32_t*>(s), static_cast<Out*>(out),
      batch, ks1, m, g, polys, stride, cluster, shift);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename Out, int LU>
int launch_recombine_inv(const void* s, void* out, int batch, int ks1, int lu,
                         int l, int m, int shift, void* stream) {
  if (lu != LU || m < l || (m & (m - 1)) || m % l || shift < 1 || shift > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (l) {
    case 2:
      return launch_recombine_l<V, Out, 2, LU>(s, out, batch, ks1, m, shift, stream);
    case 4:
      return launch_recombine_l<V, Out, 4, LU>(s, out, batch, ks1, m, shift, stream);
    case 8:
      return launch_recombine_l<V, Out, 8, LU>(s, out, batch, ks1, m, shift, stream);
    case 16:
      return launch_recombine_l<V, Out, 16, LU>(s, out, batch, ks1, m, shift, stream);
    case 32:
      return launch_recombine_l<V, Out, 32, LU>(s, out, batch, ks1, m, shift, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return launch_recombine_inv<uint64_t, uint32_t, 5>(s, out, batch, ks1, lu,
                                                     l, m, shift, stream);
}

int ctt_recombine_inv64(const void* s, void* out, int batch, int ks1, int lu,
                        int l, int m, int shift, void* stream) {
  return launch_recombine_inv<K6Value, uint64_t, 9>(s, out, batch, ks1, lu,
                                                    l, m, shift, stream);
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
