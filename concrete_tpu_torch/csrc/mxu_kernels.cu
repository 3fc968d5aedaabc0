// Hand-written Hopper (sm_90a) kernels of the toeplitz ("mxu") blind
// rotation: K1 build_tables, K2 rotdig, K3 rotdig_recombine (u32 torus) and
// K4 rotdig64 (u64 torus), which replace the Pallas kernels of
// concrete_tpu/core/bootstrap_mxu.py and compute the same bits,
// recombine_acc (both tori), which has no Pallas counterpart, and
// window_step (u64 torus, small batch), K1 fused with the product and the
// recombine that follow it; the plain
// PyTorch versions beside the wrappers
// (concrete_tpu_torch/core/bootstrap_mxu.py) define what each one returns.
//
// Torus values arrive as int32 / int64 tensors holding u32 / u64 bit
// patterns; every torus operation here is on uint32_t / uint64_t, whose
// wrap is defined (signed overflow is not). Only the sub-digit split works
// in int32, as the JAX code does, on digits far from overflow.
//
// Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmxu_kernels.so mxu_kernels.cu
// Each extern "C" entry point launches one kernel on the given stream and
// returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kSubChunkBits = 7;  // MxuPlan.SUB_CHUNK_BITS

// Coefficient c of X^a * row mod (X^N + 1), N = n a power of two: a signed
// gather. t = (c - a) mod 2N; t >= N is the wrapped half (X^N == -1).
__device__ __forceinline__ uint32_t rotated(const uint32_t* row, int c,
                                            int32_t a, int n) {
  const uint32_t t = (static_cast<uint32_t>(c) - static_cast<uint32_t>(a)) &
                     static_cast<uint32_t>(2 * n - 1);
  const uint32_t v = row[t & static_cast<uint32_t>(n - 1)];
  return t >= static_cast<uint32_t>(n) ? 0u - v : v;
}

// Signed gadget digits of four consecutive coefficients c0..c0+3 of one
// polynomial's rotation delta, written as packed int8 into the lane's
// digit-matrix row. closest_representable + decompose_levels
// (concrete_tpu/math/decomposition.py), level l first; each digit is split
// into n_sub balanced 7-bit chunks (_split_subdigits, MSB chunk = sub 0) at
// column block ((lev * n_sub + sub) * ks1 + ki) * N.
// non_rep = 32 - base_log*level lies in [0, 31]: no shift reaches the word
// width (at non_rep = 0 nothing is rounded and the shift is 0).
// |digit| <= 2^(base_log-1) <= 2^30 fits int32.
__device__ __forceinline__ void emit_digits(int8_t* d8_row,
                                            const uint32_t diff[4], int ki,
                                            int ks1, int n, int c0,
                                            int base_log, int level,
                                            int n_sub) {
  const int non_rep = 32 - base_log * level;
  uint32_t state[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t d = diff[q];
    if (non_rep > 0) {
      const uint32_t msb = (d >> (non_rep - 1)) & 1u;
      d = ((d >> non_rep) + msb) << non_rep;
    }
    state[q] = d >> non_rep;
  }
  const uint32_t mask = (1u << base_log) - 1u;
  for (int step = 0; step < level; ++step) {
    const int lev = level - 1 - step;
    int32_t digit[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t res = state[q] & mask;
      const uint32_t st = state[q] >> base_log;
      uint32_t carry = ((res - 1u) | st) & res;
      carry >>= base_log - 1;
      state[q] = st + carry;
      digit[q] = static_cast<int32_t>(res - (carry << base_log));
    }
    for (int j = 0; j < n_sub; ++j) {  // j = 0: least significant chunk
      uint32_t packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int32_t e = digit[q];
        if (j < n_sub - 1) {
          e = ((digit[q] + (1 << (kSubChunkBits - 1))) &
               ((1 << kSubChunkBits) - 1)) -
              (1 << (kSubChunkBits - 1));
          digit[q] = (digit[q] - e) >> kSubChunkBits;
        }
        packed |= (static_cast<uint32_t>(e) & 0xFFu) << (8 * q);
      }
      const int sub = n_sub - 1 - j;
      const size_t col =
          static_cast<size_t>((lev * n_sub + sub) * ks1 + ki) * n + c0;
      *reinterpret_cast<uint32_t*>(d8_row + col) = packed;
    }
  }
}

// The rotdig body on one polynomial already in shared memory.
__device__ __forceinline__ void rotdig_row(const uint32_t* row, int32_t a,
                                           int8_t* d8_row, int ki, int ks1,
                                           int n, int base_log, int level,
                                           int n_sub) {
  for (int c0 = threadIdx.x * 4; c0 < n; c0 += blockDim.x * 4) {
    uint32_t diff[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      diff[q] = rotated(row, c0 + q, a, n) - row[c0 + q];
    }
    emit_digits(d8_row, diff, ki, ks1, n, c0, base_log, level, n_sub);
  }
}

// K2 rotdig. Replaces concrete_tpu/core/bootstrap_mxu.py:_rotdig_pallas.
// acc [k+1, B, N] u32, a_hat [B] i32 -> d8 [B, R*N] i8,
// R = level*n_sub*(k+1).
// One block per (lane b, polynomial ki); the polynomial sits in shared
// memory (N <= 4096 words: 16 KB) and each thread gathers its rotated
// coefficients from it, in place of the TPU kernel's barrel of static rolls
// (which existed only because its compiler hung on dynamic rolls).
// Bound on the card: HBM traffic, 4 bytes read and R/(k+1) bytes written
// per coefficient.
// Design: the acc row is read once, 16 bytes a thread, and the digits leave
// as packed 4-byte stores, so a warp writes 128 contiguous bytes.
__global__ void rotdig_kernel(const uint32_t* __restrict__ acc,
                              const int32_t* __restrict__ a_hat,
                              int8_t* __restrict__ d8, int batch, int ks1,
                              int n, int base_log, int level, int n_sub) {
  extern __shared__ uint4 row_words[];
  uint32_t* row = reinterpret_cast<uint32_t*>(row_words);
  const int b = blockIdx.x;
  const int ki = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      acc + (static_cast<size_t>(ki) * batch + b) * n);
  const int n16 = n / 4;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    row_words[i] = src[i];
  }
  __syncthreads();
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * n;
  rotdig_row(row, a_hat[b], d8 + b * d8_cols, ki, ks1, n, base_log, level,
             n_sub);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One level of decompose_levels on the state s (uint32_t or uint64_t):
// returns the signed digit and leaves the state shifted by base_log, plus
// the carry. The state is kept mod 2^(bits left): the carry out of the
// top is dropped, and a state that overflows to 2^bits has zero bits
// below, so every later res, carry and digit is 0 either way. At the last
// level the state is at most 2^base_log, so st is 0 or (with res = 0) 1
// and the carry needs no st.
template <typename T>
__device__ __forceinline__ int32_t gadget_digit(T& s, int bl, bool last) {
  const T res = s & ((T(1) << bl) - T(1));
  const T st = last ? T(0) : s >> bl;
  const T carry = (((res - T(1)) | st) & res) >> (bl - 1);
  s = st + carry;
  return static_cast<int32_t>(static_cast<uint32_t>(res) -
                              (static_cast<uint32_t>(carry) << bl));
}

// K4 rotdig64. Replaces concrete_tpu/core/bootstrap_mxu.py:_rotdig_pallas64.
// acc [k+1, B, N] u64, a_hat [B] i32 -> d8 [B, R*N] i8,
// R = level*n_sub*(k+1), for every base_log*level <= 64 (the TPU kernel
// stopped at 32 bits, where its u32 word planes ran out).
// Bound on the card: HBM traffic, 8 bytes read and R/(k+1) bytes written a
// coefficient (13.8 us at the int4 shape, B=2048). The fewest 32-bit
// instructions the digit work needs (chip_smoke.rotdig64_work: 32-58 a
// coefficient at the main paths' gadgets) take a third of that at the
// integer pipes' rates; but the earlier kernel, on native uint64_t with
// the level and sub-digit loops at run time, issued 134-199 (its SASS,
// tools/k4_sweep.py) and 4-way conflicted shared loads, and ran at 44-51%
// of the bytes bound: instruction issue, not HBM, held it. This one issues
// 61-91 and runs at 75-82%; what is left is that a row's load and its
// digit work and stores overlap only in part (PERF.md, section 6).
// Design:
// - The digit state is 32 bits wide as soon as it fits, as in the TPU
//   kernel: the rounded prefix (diff + 2^(non_rep-1)) >> non_rep comes
//   from the 64-bit difference, and where base_log*level <= 32 every level
//   runs on uint32_t. Wider prefixes run their lowest levels on uint64_t
//   until the bits left fit 32 (gadget_digit keeps them mod 2^bits left).
//   The loop is unrolled for the main paths' (base_log, level, n_sub),
//   which carries the gain: the generic instance (all 0), which takes the
//   rest of the envelope, runs at about the earlier kernel's time.
// - A conflict-free gather: thread g owns coefficients 4g..4g+3 (one
//   packed 4-byte store a level and sub-digit), and loads its four words
//   in the order rotated by (g >> 2) & 3, so the 16 lanes of a half warp
//   read 16 different 8-byte bank pairs; the last __byte_perm of the
//   packing undoes the rotation.
// - A block owns kRd64Rows consecutive (ki, b) rows in a double buffer:
//   the next row's cp.async is in flight while this row's digits are
//   computed and stored.
constexpr int kRd64Threads = 128;  // threads a block (N/4 below N = 512)
constexpr int kRd64Rows = 4;       // (ki, b) rows a block

template <int BL, int L, int NSUB>
__global__ void __launch_bounds__(kRd64Threads)
    rotdig64_kernel(const uint64_t* __restrict__ acc,
                    const int32_t* __restrict__ a_hat,
                    int8_t* __restrict__ d8, int batch, int ks1, int n,
                    int base_log, int level_rt, int n_sub_rt) {
  extern __shared__ uint4 rows_words[];  // two row buffers
  const int bl = BL ? BL : base_log;
  const int level = L ? L : level_rt;
  const int n_sub = NSUB ? NSUB : n_sub_rt;
  const int prefix = bl * level;
  const int non_rep = 64 - prefix;
  const uint64_t half = non_rep ? uint64_t(1) << (non_rep - 1) : 0;
  // levels run on the 64-bit state before the bits left fit 32
  const int wide = prefix > 32 ? (prefix - 32 + bl - 1) / bl : 0;
  const int n16 = n / 2;
  const int g0 = blockIdx.x * kRd64Rows;
  const int g1 = min(g0 + kRd64Rows, batch * ks1);
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * n;
  const size_t blk_stride = static_cast<size_t>(ks1) * n;  // a column block
  // word q of a thread's window is coefficient c0 + ((q + rot) & 3); the
  // packing's last selector puts the bytes back in coefficient order
  const int rot = (threadIdx.x >> 2) & 3;
  const uint32_t order = (0x54105410u >> (16 - 4 * rot)) & 0xFFFFu;

  auto load = [&](int g) {  // row g = ki * batch + b of acc, async
    const uint4* src = reinterpret_cast<const uint4*>(acc + size_t(g) * n);
    uint4* dst = rows_words + ((g - g0) & 1) * n16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x) {
      cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  load(g0);
  int ki = g0 / batch;  // row g0 = ki * batch + b, then b steps through
  int b = g0 - ki * batch;
  for (int g = g0; g < g1; ++g) {
    if (g + 1 < g1) {
      load(g + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint64_t* row =
        reinterpret_cast<const uint64_t*>(rows_words + ((g - g0) & 1) * n16);
    const uint32_t a = static_cast<uint32_t>(a_hat[b]);
    int8_t* out = d8 + b * d8_cols + static_cast<size_t>(ki) * n;
    for (int c0 = 4 * threadIdx.x; c0 < n; c0 += 4 * blockDim.x) {
      uint64_t s64[4];
      uint32_t s32[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t c = c0 + ((q + rot) & 3);
        const uint32_t t = (c - a) & static_cast<uint32_t>(2 * n - 1);
        const uint64_t v = row[t & static_cast<uint32_t>(n - 1)];
        // X^a * acc - acc at c, plus the rounding half; the wrapped half
        // (t >= N) negates v, branch-free
        const uint64_t m = uint64_t(0) - uint64_t((t & n) != 0);
        const uint64_t d = (v ^ m) - m - row[c] + half;
        s64[q] = d >> non_rep;
      }
#pragma unroll
      for (int step = 0; step < level; ++step) {
        const int lev = level - 1 - step;
        int32_t digit[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (step < wide) {
            digit[q] = gadget_digit(s64[q], bl, false);
          } else {
            if (step == wide) s32[q] = static_cast<uint32_t>(s64[q]);
            digit[q] = gadget_digit(s32[q], bl, step == level - 1);
          }
        }
#pragma unroll
        for (int j = 0; j < n_sub; ++j) {  // j = 0: least significant chunk
          uint32_t e[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            e[q] = static_cast<uint32_t>(digit[q]);
            if (j < n_sub - 1) {  // balanced 7-bit chunk, the rest carried
              const int32_t rest =
                  (digit[q] + (1 << (kSubChunkBits - 1))) >> kSubChunkBits;
              e[q] = static_cast<uint32_t>(digit[q] -
                                           rest * (1 << kSubChunkBits));
              digit[q] = rest;
            }
          }
          const uint32_t packed = __byte_perm(__byte_perm(e[0], e[1], 0x0040),
                                              __byte_perm(e[2], e[3], 0x0040),
                                              order);
          const int sub = n_sub - 1 - j;
          *reinterpret_cast<uint32_t*>(
              out + (lev * n_sub + sub) * blk_stride + c0) = packed;
        }
      }
    }
    if (++b == batch) {
      b = 0;
      ++ki;
    }
    __syncthreads();  // the buffer is refilled by row g + 2's load
  }
}

// K3 rotdig_recombine. Replaces
// concrete_tpu/core/bootstrap_mxu.py:_rotdig_recombine_pallas.
// s [B, (k+1)*lu*N] i32 (the previous step's dot output, limb planes
// contiguous), acc [k+1, B, N] u32, a_hat [B] i32 ->
// acc_new = acc + sum_j s_j << 8(limb_drop + j) (wrapping), and d8 = K2's
// digits of acc_new. acc_new may alias acc: each thread reads its four
// coefficients of acc before writing them back, and the rotation reads the
// shared-memory copy. Bound on the card: HBM reads of S (lu*4 bytes per
// coefficient, the largest stream), then K2's traffic. Design: the same
// blocking as K2, with S read 16 bytes a thread; folding the recombine here
// saves the separate recombine + accumulate passes over S and acc.
__global__ void rotdig_recombine_kernel(const int32_t* __restrict__ s,
                                        const uint32_t* acc,
                                        const int32_t* __restrict__ a_hat,
                                        uint32_t* acc_new,
                                        int8_t* __restrict__ d8, int batch,
                                        int ks1, int n, int limbs_used,
                                        int limb_drop, int base_log,
                                        int level, int n_sub) {
  extern __shared__ uint4 row_words[];
  uint32_t* row = reinterpret_cast<uint32_t*>(row_words);
  const int b = blockIdx.x;
  const int ki = blockIdx.y;
  const size_t off = (static_cast<size_t>(ki) * batch + b) * n;
  const uint32_t* s_row = reinterpret_cast<const uint32_t*>(s) +
                          (static_cast<size_t>(b) * ks1 + ki) * limbs_used * n;
  for (int c0 = threadIdx.x * 4; c0 < n; c0 += blockDim.x * 4) {
    uint4 x = *reinterpret_cast<const uint4*>(acc + off + c0);
    for (int j = 0; j < limbs_used; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_row + j * n + c0);
      const int sh = 8 * (limb_drop + j);
      x.x += v.x << sh;
      x.y += v.y << sh;
      x.z += v.z << sh;
      x.w += v.w << sh;
    }
    *reinterpret_cast<uint4*>(acc_new + off + c0) = x;
    *reinterpret_cast<uint4*>(row + c0) = x;
  }
  __syncthreads();
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * n;
  rotdig_row(row, a_hat[b], d8 + b * d8_cols, ki, ks1, n, base_log, level,
             n_sub);
}

// recombine_acc. Replaces no TPU kernel: the JAX package leaves this sum to
// XLA, which fuses recombine_limb_planes and the add after it into one
// elementwise loop; in PyTorch the same composition is ~24 kernels a step
// (a strided cast, a shift and an add per limb plane).
// s [B, (k+1)*L*N] i32 (the step's dot output; columns in (kj, m, c) order,
// as int_mm writes them), acc [k+1, B, N] in the carrier U (uint32_t on the
// u32 torus, uint64_t on u64) -> out = acc + sum_m s_m << 8(limb_drop + m),
// wrapping mod 2^(8 sizeof(U)): each limb is sign-extended to U, the sum is
// in U's unsigned arithmetic. out may alias acc: each thread reads its four
// coefficients of acc before it writes them.
// Bound on the card: HBM bytes, S read once (4L bytes a coefficient), acc
// read and written once: 201 MB at the int4 shape (B = 2048, k+1 = 2,
// L = 8, N = 1024), 60 us at 3.35 TB/s.
// Design: a thread owns 4 consecutive coefficients of one (kj, b) row, and
// consecutive lanes take consecutive coefficients, so each of its L limb
// loads and its acc load and store is a 16-byte vector a lane (two on u64),
// coalesced into 512-byte runs a warp. L is a template argument, so all L
// loads are issued before the first add. No shared memory, no barrier.
// Blocks of 256 threads on the main path; fewer where the grid would give
// the 132 SMs fewer than two blocks each (B = 16).
constexpr int kRecombineThreads = 256;
constexpr int kSms = 132;  // H100 SXM

template <typename U, int L>
__global__ void __launch_bounds__(kRecombineThreads)
    recombine_acc_kernel(const int32_t* __restrict__ s, const U* acc, U* out,
                         int batch, int ks1, int n, int limb_drop) {
  using Signed = typename std::make_signed<U>::type;
  constexpr int kVecs = static_cast<int>(sizeof(U)) / 4;  // uint4 a quad
  const int row = blockIdx.x;  // kj * B + b, acc's row
  const int kj = row / batch;
  const int b = row - kj * batch;
  const int c0 = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
  const int32_t* s_row =
      s + (static_cast<size_t>(b) * ks1 + kj) * L * n + c0;
  int4 v[L];
#pragma unroll
  for (int m = 0; m < L; ++m) {
    v[m] = *reinterpret_cast<const int4*>(s_row + static_cast<size_t>(m) * n);
  }
  const size_t off = static_cast<size_t>(row) * n + c0;
  uint4 raw[kVecs];
#pragma unroll
  for (int w = 0; w < kVecs; ++w) {
    raw[w] = reinterpret_cast<const uint4*>(acc + off)[w];
  }
  U sum[4] = {0, 0, 0, 0};
#pragma unroll
  for (int m = 0; m < L; ++m) {
    sum[0] += static_cast<U>(static_cast<Signed>(v[m].x)) << (8 * m);
    sum[1] += static_cast<U>(static_cast<Signed>(v[m].y)) << (8 * m);
    sum[2] += static_cast<U>(static_cast<Signed>(v[m].z)) << (8 * m);
    sum[3] += static_cast<U>(static_cast<Signed>(v[m].w)) << (8 * m);
  }
  U x[4];
  memcpy(x, raw, sizeof(x));
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] += sum[q] << (8 * limb_drop);
  memcpy(raw, x, sizeof(x));
#pragma unroll
  for (int w = 0; w < kVecs; ++w) {
    reinterpret_cast<uint4*>(out + off)[w] = raw[w];
  }
}

// K1 build_tables. Replaces
// concrete_tpu/core/bootstrap_mxu.py:_build_tables_pallas.
// rings [R, (k+1)*n_words, 2N] u32 word planes (n_words = 1 for the u32
// torus, 2 for u64; 2 or 3 for the Nussbaumer rings, whose high limbs the
// caller drops through n_kept) -> the toeplitz RHS, whose logical entry
// (blk*N + r, (kj*n_kept + li)*N + c) is global byte g = limb_drop + li,
// i.e. byte g % 4 of word plane kj*n_words + g / 4, of ring[blk, kj][(c - r)
// mod 2N]. It is stored column-major, the layout cuBLASLt's int8 product
// reads fastest: the R blocks split into `groups` consecutive groups of
// Rg = R/groups (one per Nussbaumer frequency; 1 on the toeplitz path), and
// out[grp][col][bl*N + r] holds the entry of row (grp*Rg + bl)*N + r.
// Bound on the card: pure HBM write bandwidth (R*N x (k+1)*n_kept*N bytes:
// 13 MB a step at TPU128, 101 MB for the u64 int4 configuration, 906 MB on
// the int4 N=8192 Nussbaumer rings); the rings are read once.
// Design: in column-major order a column's run over one ring block is a
// contiguous window of the reversed 2N-cyclic byte plane of one ring word
// plane: out[r] = P_j[(c - r) mod 2N]. A block owns one ring word plane and
// a tile of C columns; it stages the N + C + 16 ring words the tile reads,
// reversed and split into the 4 byte planes (a 4 x 4 byte transpose by
// __byte_perm), in shared memory once. Each thread then makes 16 output
// bytes from two aligned 16-byte shared loads and four __funnelshift_r, and
// stores them as one 16-byte vector; consecutive lanes take consecutive
// 16-byte pieces of one column's run, so a warp writes up to 512
// contiguous bytes. No gather per byte and no reread of the ring from L2.
constexpr int kTableThreads = 256;

__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b,
                                             uint32_t c, uint32_t d,
                                             uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140);
  const uint32_t t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);  // a0 b0 c0 d0
  out[1] = __byte_perm(t0, t2, 0x7632);  // a1 b1 c1 d1
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__global__ void __launch_bounds__(kTableThreads) build_tables_kernel(
    const uint32_t* __restrict__ rings, int8_t* __restrict__ out, int ks1,
    int n, int n_kept, int limb_drop, int n_words, int rg, int tile) {
  extern __shared__ uint4 stage4[];
  const int plane = blockIdx.z;  // kj * n_words + w
  const int kj = plane / n_words;
  const int w = plane - kj * n_words;
  // kept bytes j of this word: global limb 4w + j in [limb_drop,
  // limb_drop + n_kept)
  const int j_lo = max(limb_drop - 4 * w, 0);
  const int j_hi = min(limb_drop + n_kept - 4 * w, 4);
  if (j_hi <= j_lo) return;
  const int blk = blockIdx.y;
  const int c0 = blockIdx.x * tile;
  const int v_words = (n + tile + 16) / 4;  // staged bytes per byte plane / 4
  uint32_t* stage = reinterpret_cast<uint32_t*>(stage4);
  const uint32_t* ring =
      rings + (static_cast<size_t>(blk) * ks1 * n_words + plane) * 2 * n;
  // stage[j][v] = byte j of ring[(c0 + tile - 1 - v) mod 2N]
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  const uint32_t c_hi = static_cast<uint32_t>(c0 + tile - 1);
  for (int k = threadIdx.x; k < v_words; k += blockDim.x) {
    const uint32_t v = 4u * k;
    uint32_t t[4];
    transpose4x4(__ldg(ring + ((c_hi - v) & wrap)),
                 __ldg(ring + ((c_hi - v - 1u) & wrap)),
                 __ldg(ring + ((c_hi - v - 2u) & wrap)),
                 __ldg(ring + ((c_hi - v - 3u) & wrap)), t);
#pragma unroll
    for (int j = 0; j < 4; ++j) stage[j * v_words + k] = t[j];
  }
  __syncthreads();
  const int chunks = n / 16;
  const int tasks = (j_hi - j_lo) * tile * chunks;
  const int grp = blk / rg;
  const size_t rows = static_cast<size_t>(rg) * n;
  const size_t cols = static_cast<size_t>(ks1) * n_kept * n;
  int8_t* out_blk = out + grp * cols * rows + (blk - grp * rg) * n;
  for (int it = threadIdx.x; it < tasks; it += blockDim.x) {
    const int chunk = it % chunks;
    const int rest = it / chunks;
    const int cl = rest % tile;
    const int j = j_lo + rest / tile;
    const int base = tile - 1 - cl + 16 * chunk;  // out[16*chunk] = stage[j][base]
    const uint4* src = stage4 + (j * v_words) / 4 + (base >> 4);
    const uint4 x = src[0], y = src[1];
    const uint32_t wv[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    const int q = (base >> 2) & 3;
    const int sh = 8 * (base & 3);
    uint32_t v[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      v[i] = q == 0 ? wv[i] : q == 1 ? wv[i + 1] : q == 2 ? wv[i + 2] : wv[i + 3];
    }
    uint4 o;
    o.x = __funnelshift_r(v[0], v[1], sh);
    o.y = __funnelshift_r(v[1], v[2], sh);
    o.z = __funnelshift_r(v[2], v[3], sh);
    o.w = __funnelshift_r(v[3], v[4], sh);
    const int li = 4 * w + j - limb_drop;
    const size_t col = static_cast<size_t>(kj * n_kept + li) * n + c0 + cl;
    *reinterpret_cast<uint4*>(out_blk + col * rows + 16 * chunk) = o;
  }
}

// window_step. Replaces no Pallas kernel of its own: it fuses K1
// (concrete_tpu/core/bootstrap_mxu.py:_build_tables_pallas), the XLA dot
// after it and the recombine and accumulate of one u64 CMux step, at small
// batch. d8 [B, R*N] i8 (K4's digits), rings [R, (k+1)*2, 2N] u32 (one
// step's bsk_to_mxu rings, two word planes a u64 coefficient), out [k+1, B,
// N] u64 -> out += sum_li S_li << 8(limb_drop + li) mod 2^64, S = d8 @ the
// toeplitz table of the rings (build_tables_plain), bit for bit.
// Bound on the card at the int4 shape, B = 16: the int8 operations, 2 * 16
// * 6144 * 16384 = 3.2 G (1.6 us at 1,979 TOP/s), and the bytes of d8,
// the rings and acc, ~0.6 MB (0.2 us). The unfused step writes the 100 MB
// table and reads it back for 16 rows: 60 us at 3.35 TB/s.
// Design:
// - No table in device memory. Entry (r*N + i, (kj, li, c)) is byte
//   limb_drop + li of ring[r][kj][(c - i) mod 2N], so a block that owns 64
//   coefficients and dn rows i0.. of one ring block's contraction needs
//   dn + 64 words of each word plane. It stages them once, reversed and
//   split into L byte planes (K1's 4 x 4 byte transpose): entry (i0 + i,
//   c) is then byte 63 - (c - cb) + i of its limb's plane.
// - The fragments come from those planes in registers. The contraction's
//   order is free as long as A and B agree, so in a chunk of KC rows
//   thread t of an mma quad takes the KC/4 consecutive rows from KC/4 * t
//   on: an n8 tile's B fragment is then 4-byte words of one byte run, and
//   the next n8 tile's run is the same one 8 bytes earlier (the toeplitz
//   shift). A thread loads 15 + KC/16 plane words a chunk and funnel-shifts
//   them once into all 8 tiles' fragments; A comes from the block's d8
//   rows in shared memory (cp.async), two 16-byte loads a row and chunk.
// - int8 tensor cores: mma.sync m16n8k32, int32 sums, exact (the plan
//   keeps R*N*64*128 < 2^31); a warp owns one limb, all 64 columns and
//   MT m16 tiles of batch rows (16 * MT rows a block).
// - The contraction splits over the grid: by ring block (R blocks a
//   column tile), and each ring block in `splits` parts where the grid
//   would give the 132 SMs fewer than two blocks each (two at the int4
//   B = 16 shape: 384 blocks in place of 192, whose SMs of two blocks
//   held the mma.sync pipe twice as long as those of one). Each block
//   recombines its partial sums (the limbs meet in shared memory) and adds
//   them into out with 64-bit atomic adds: they wrap mod 2^64, so any
//   order gives the same bits, and no second pass is needed.
constexpr int kWinCols = 64;  // coefficients of a block's column tile
constexpr int kWinTiles = kWinCols / 8;  // its n8 tiles
constexpr int kWinLead = 2 * (kWinTiles - 1);  // fragment words before
                                               // tile 0's k-step 0
constexpr int kWinRedStride = kWinCols + 8;  // int32 row of the limb sums

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// d += a (16x32 s8, row) * b (32x8 s8, col), wrapping int32
__device__ __forceinline__ void mma_s8(int32_t d[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// shared bytes of a window_step block of depth dn: the d8 rows and the
// byte planes, later the limbs' int32 sums
size_t window_smem(int rows, int dn, int limbs) {
  const size_t stage = static_cast<size_t>(rows) * (dn + 16) +
                       static_cast<size_t>(limbs) * (dn + kWinCols);
  const size_t red = static_cast<size_t>(limbs) * 16 * kWinRedStride * 4;
  return stage > red ? stage : red;
}

template <int MT, int KC>
__global__ void __launch_bounds__(256)
    window_step_kernel(const int8_t* __restrict__ d8,
                       const uint32_t* __restrict__ rings,
                       unsigned long long* out, int batch, int ks1, int n,
                       int splits, int limbs, int limb_drop) {
  constexpr int kRows = 16 * MT;
  constexpr int kRun = KC / 4;     // contraction rows a thread takes a chunk
  constexpr int kSteps = KC / 32;  // mma k-steps a chunk
  constexpr int kF = kWinLead + 2 * kSteps;  // fragment words a chunk
  extern __shared__ __align__(16) uint8_t smem8[];
  const int dn = n / splits;         // the block's contraction rows
  const int a_stride = dn + 16;      // 16-byte loads of 8 rows on 32 banks
  const int q_stride = dn + kWinCols;
  uint8_t* a_s = smem8;                      // [kRows][a_stride]
  uint8_t* q_s = smem8 + kRows * a_stride;   // [limbs][q_stride]
  const int cb = blockIdx.x * kWinCols;
  const int r = blockIdx.y / splits;         // ring block, rows i0.. of it
  const int i0 = (blockIdx.y - r * splits) * dn;
  const int groups = gridDim.z / ks1;
  const int kj = blockIdx.z / groups;
  const int b0 = (blockIdx.z - kj * groups) * kRows;
  const size_t depth = static_cast<size_t>(gridDim.y / splits) * n;  // R*N

  // the block's d8 columns r*N + i0.., rows past the batch zero
  const int parts = dn / 16;
  for (int i = threadIdx.x; i < kRows * parts; i += blockDim.x) {
    const int row = i / parts;
    const int part = i - row * parts;
    const bool valid = b0 + row < batch;
    const int8_t* src =
        d8 + (valid ? (b0 + row) * depth + static_cast<size_t>(r) * n + i0 +
                          16 * part
                    : 0);
    cp_async16_zfill(a_s + row * a_stride + 16 * part, src, valid ? 16 : 0);
  }
  cp_async_commit();
  // plane li, byte u = byte (limb_drop + li) % 4 of word plane (limb_drop
  // + li) / 4 of ring[(cb + 63 - i0 - u) mod 2N]; the four ring words of
  // a plane word are one aligned 16-byte load (cb and i0 are multiples of
  // 64)
  const int words = q_stride / 4;
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  const uint32_t c_lo = static_cast<uint32_t>(cb + kWinCols - 4 - i0);
  for (int it = threadIdx.x; it < 2 * words; it += blockDim.x) {
    const int w = it / words;
    const uint32_t v = 4u * (it - w * words);
    const int j_lo = max(limb_drop - 4 * w, 0);
    const int j_hi = min(limb_drop + limbs - 4 * w, 4);
    if (j_hi <= j_lo) continue;
    const uint32_t* ring =
        rings + (static_cast<size_t>(r) * ks1 * 2 + kj * 2 + w) * 2 * n;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(
        ring + ((c_lo - v) & wrap)));
    uint32_t t4[4];
    transpose4x4(x.w, x.z, x.y, x.x, t4);
    for (int j = j_lo; j < j_hi; ++j) {
      reinterpret_cast<uint32_t*>(q_s + (4 * w + j - limb_drop) *
                                            q_stride)[v / 4] = t4[j];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;  // the limb
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma group: A row, B column
  const int t = lane & 3;   // its thread: the contraction rows
  // tile nt's entry (kb + kRun*t + x, 8*nt + g) is plane byte 63 - g -
  // 8*nt + kb + kRun*t + x: fragment word j of a chunk is the plane's
  // bytes from 4*(first + j) + sh, and tile nt's k-step s takes words
  // kWinLead - 2*nt + 2*s (+1)
  const uint32_t* plane = reinterpret_cast<const uint32_t*>(
      q_s + warp * q_stride);
  const int first = ((kWinCols - 1 - g) >> 2) + (kRun / 4) * t - kWinLead;
  const uint32_t sh = 8u * ((3 - g) & 3);
  int32_t sum[MT][kWinTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kWinTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0;

  for (int kb = 0; kb < dn; kb += KC) {
    const uint32_t* src = plane + (kb >> 2) + first;
    uint32_t f[kF];
    uint32_t lo = src[0];
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      const uint32_t hi = src[j + 1];
      f[j] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* arow = a_s + (16 * mt + g) * a_stride + kb + kRun * t;
      uint32_t a_lo[kRun / 4], a_hi[kRun / 4];  // rows g and g + 8
#pragma unroll
      for (int q = 0; q < kRun / 16; ++q) {
        const uint4 x = *reinterpret_cast<const uint4*>(arow + 16 * q);
        const uint4 y =
            *reinterpret_cast<const uint4*>(arow + 8 * a_stride + 16 * q);
        a_lo[4 * q] = x.x, a_lo[4 * q + 1] = x.y;
        a_lo[4 * q + 2] = x.z, a_lo[4 * q + 3] = x.w;
        a_hi[4 * q] = y.x, a_hi[4 * q + 1] = y.y;
        a_hi[4 * q + 2] = y.z, a_hi[4 * q + 3] = y.w;
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint32_t a[4] = {a_lo[2 * s], a_hi[2 * s], a_lo[2 * s + 1],
                               a_hi[2 * s + 1]};
#pragma unroll
        for (int nt = 0; nt < kWinTiles; ++nt) {
          const uint32_t b[2] = {f[kWinLead - 2 * nt + 2 * s],
                                 f[kWinLead + 1 - 2 * nt + 2 * s]};
          mma_s8(sum[mt][nt], a, b);
        }
      }
    }
  }

  // the limbs meet in shared memory; each output word is recombined once
  // and added into out
  __syncthreads();  // every warp is done with the d8 rows and the planes
  int32_t* red = reinterpret_cast<int32_t*>(smem8);  // [limbs][16][stride]
  int32_t* mine = red + warp * 16 * kWinRedStride;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kWinTiles; ++nt) {
      *reinterpret_cast<int2*>(mine + g * kWinRedStride + 8 * nt + 2 * t) =
          make_int2(sum[mt][nt][0], sum[mt][nt][1]);
      *reinterpret_cast<int2*>(mine + (g + 8) * kWinRedStride + 8 * nt +
                               2 * t) = make_int2(sum[mt][nt][2],
                                                  sum[mt][nt][3]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 16 * kWinCols; i += blockDim.x) {
      const int row = i / kWinCols;
      const int col = i - row * kWinCols;
      const int b = b0 + 16 * mt + row;
      if (b < batch) {
        unsigned long long x = 0;
        for (int li = 0; li < limbs; ++li) {
          x += static_cast<unsigned long long>(static_cast<long long>(
                   red[(li * 16 + row) * kWinRedStride + col]))
               << (8 * (limb_drop + li));
        }
        atomicAdd(out + (static_cast<size_t>(kj) * batch + b) * n + cb + col,
                  x);
      }
    }
    __syncthreads();  // red is rewritten by the next m16 tile
  }
}

template <int MT, int KC>
int launch_window_step(const void* d8, const void* rings, void* out,
                       int batch, int ks1, int n, int r_blocks, int splits,
                       int limbs, int limb_drop, cudaStream_t stream) {
  const size_t smem = window_smem(16 * MT, n / splits, limbs);
  static size_t raised = 48 * 1024;  // the dynamic shared bytes allowed
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_step_kernel<MT, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = smem;
  }
  const int groups = (batch + 16 * MT - 1) / (16 * MT);
  window_step_kernel<MT, KC>
      <<<dim3(n / kWinCols, r_blocks * splits, ks1 * groups), 32 * limbs,
         smem, stream>>>(static_cast<const int8_t*>(d8),
                         static_cast<const uint32_t*>(rings),
                         static_cast<unsigned long long*>(out), batch, ks1, n,
                         splits, limbs, limb_drop);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int window_step_rows(const void* d8, const void* rings, void* out, int batch,
                     int ks1, int n, int r_blocks, int splits, int limbs,
                     int limb_drop, int rows, cudaStream_t stream) {
  switch (rows) {
    case 16:
      return launch_window_step<1, KC>(d8, rings, out, batch, ks1, n,
                                       r_blocks, splits, limbs, limb_drop,
                                       stream);
    case 32:
      return launch_window_step<2, KC>(d8, rings, out, batch, ks1, n,
                                       r_blocks, splits, limbs, limb_drop,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int row_threads(int n) {  // one thread per 4 coefficients, at most 1024
  const int t = n / 4;
  return t < 1024 ? t : 1024;
}

template <int BL, int L, int NSUB>
int launch_rotdig64(const void* acc, const void* a_hat, void* d8, int batch,
                    int ks1, int n, int base_log, int level, int n_sub,
                    cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(uint64_t);
  if (smem > 48 * 1024) {  // N = 4096: 64 KB
    const cudaError_t err = cudaFuncSetAttribute(
        rotdig64_kernel<BL, L, NSUB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n / 4 < kRd64Threads ? n / 4 : kRd64Threads;
  const int blocks = (batch * ks1 + kRd64Rows - 1) / kRd64Rows;
  rotdig64_kernel<BL, L, NSUB><<<blocks, threads, smem, stream>>>(
      static_cast<const uint64_t*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<int8_t*>(d8), batch, ks1, n, base_log, level, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// recombine_acc's L, a template argument, chosen from limbs_used: L counts
// down from sizeof(U), the carrier's limbs, so only valid shifts exist.
template <typename U, int L>
void launch_recombine_acc(int limbs_used, dim3 grid, int threads,
                          cudaStream_t stream, const int32_t* s, const U* acc,
                          U* out, int batch, int ks1, int n, int limb_drop) {
  if constexpr (L >= 1) {
    if (limbs_used == L) {
      recombine_acc_kernel<U, L><<<grid, threads, 0, stream>>>(
          s, acc, out, batch, ks1, n, limb_drop);
    } else {
      launch_recombine_acc<U, L - 1>(limbs_used, grid, threads, stream, s,
                                     acc, out, batch, ks1, n, limb_drop);
    }
  }
}

template <typename U>
int recombine_acc(const void* s, const void* acc, void* out, int batch,
                  int ks1, int n, int limbs_used, int limb_drop,
                  cudaStream_t stream) {
  constexpr int kLimbs = static_cast<int>(sizeof(U));
  if (batch < 1 || ks1 < 1 || n < 4 || (n & (n - 1)) || limbs_used < 1 ||
      limb_drop < 0 || limbs_used + limb_drop > kLimbs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quads = n / 4;
  const long long rows = static_cast<long long>(batch) * ks1;
  int threads = quads < kRecombineThreads ? quads : kRecombineThreads;
  while (threads > 32 && rows * (quads / threads) < 2 * kSms) threads /= 2;
  launch_recombine_acc<U, kLimbs>(
      limbs_used, dim3(static_cast<unsigned>(rows), quads / threads), threads,
      stream, static_cast<const int32_t*>(s), static_cast<const U*>(acc),
      static_cast<U*>(out), batch, ks1, n, limb_drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ctt_build_tables(const void* rings, void* out, int r_blocks, int ks1,
                     int n, int n_kept, int limb_drop, int n_words, int groups,
                     void* stream) {
  if (n % 16 || groups < 1 || r_blocks % groups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = n < 32 ? n : 32;  // columns a block
  // 4 staged byte planes: 16.6 KB at N = 4096, the largest ring
  const size_t smem = static_cast<size_t>(4) * (n + tile + 16);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  build_tables_kernel<<<dim3(n / tile, r_blocks, ks1 * n_words),
                        kTableThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rings), static_cast<int8_t*>(out), ks1, n,
      n_kept, limb_drop, n_words, r_blocks / groups, tile);
  return static_cast<int>(cudaGetLastError());
}

int ctt_rotdig(const void* acc, const void* a_hat, void* d8, int batch,
               int ks1, int n, int base_log, int level, int n_sub,
               void* stream) {
  rotdig_kernel<<<dim3(batch, ks1), row_threads(n), n * sizeof(uint32_t),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<int8_t*>(d8), batch, ks1, n, base_log, level, n_sub);
  return static_cast<int>(cudaGetLastError());
}

int ctt_rotdig64(const void* acc, const void* a_hat, void* d8, int batch,
                 int ks1, int n, int base_log, int level, int n_sub,
                 void* stream) {
  if (base_log < 1 || base_log > 31 || level < 1 || n_sub < 1 ||
      base_log * level > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
#define CTT_ROTDIG64(BL, L, NSUB)                                           \
  if (base_log == BL && level == L && n_sub == NSUB) {                      \
    return launch_rotdig64<BL, L, NSUB>(acc, a_hat, d8, batch, ks1, n,      \
                                        base_log, level, n_sub, st);        \
  }
  // unrolled: the int4 LUT (examples/int4_lut.py), function_bootstrap and
  // the other phase-A gadgets of chip_smoke.py
  CTT_ROTDIG64(7, 3, 1)
  CTT_ROTDIG64(10, 3, 2)
  CTT_ROTDIG64(16, 2, 3)
  CTT_ROTDIG64(16, 3, 3)
#undef CTT_ROTDIG64
  return launch_rotdig64<0, 0, 0>(acc, a_hat, d8, batch, ks1, n, base_log,
                                  level, n_sub, st);
}

int ctt_rotdig_recombine(const void* s, const void* acc, const void* a_hat,
                         void* acc_new, void* d8, int batch, int ks1, int n,
                         int limbs_used, int limb_drop, int base_log,
                         int level, int n_sub, void* stream) {
  rotdig_recombine_kernel<<<dim3(batch, ks1), row_threads(n),
                            n * sizeof(uint32_t),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(s), static_cast<const uint32_t*>(acc),
      static_cast<const int32_t*>(a_hat), static_cast<uint32_t*>(acc_new),
      static_cast<int8_t*>(d8), batch, ks1, n, limbs_used, limb_drop,
      base_log, level, n_sub);
  return static_cast<int>(cudaGetLastError());
}

int ctt_recombine_acc(const void* s, const void* acc, void* out, int batch,
                      int ks1, int n, int limbs_used, int limb_drop,
                      void* stream) {
  return recombine_acc<uint32_t>(s, acc, out, batch, ks1, n, limbs_used,
                                 limb_drop, static_cast<cudaStream_t>(stream));
}

int ctt_recombine_acc64(const void* s, const void* acc, void* out, int batch,
                        int ks1, int n, int limbs_used, int limb_drop,
                        void* stream) {
  return recombine_acc<uint64_t>(s, acc, out, batch, ks1, n, limbs_used,
                                 limb_drop, static_cast<cudaStream_t>(stream));
}

// rows: batch rows a block, 16 or 32
int ctt_window_step(const void* d8, const void* rings, void* out, int batch,
                    int ks1, int n, int r_blocks, int limbs, int limb_drop,
                    int rows, void* stream) {
  if (batch < 1 || ks1 < 1 || r_blocks < 1 || n < kWinCols ||
      (n & (n - 1)) || limbs < 1 || limb_drop < 0 || limbs + limb_drop > 8 ||
      (rows != 16 && rows != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  // each ring block in two where the grid gives an SM fewer than two
  // blocks (its depth kept a multiple of 64)
  const long long blocks = static_cast<long long>(n / kWinCols) * r_blocks *
                           ks1 * ((batch + rows - 1) / rows);
  const int splits = blocks < 2 * kSms && n >= 2 * kWinCols ? 2 : 1;
  return n / splits >= 128
             ? window_step_rows<128>(d8, rings, out, batch, ks1, n, r_blocks,
                                     splits, limbs, limb_drop, rows, st)
             : window_step_rows<64>(d8, rings, out, batch, ks1, n, r_blocks,
                                    splits, limbs, limb_drop, rows, st);
}

}  // extern "C"
