// Hand-written Hopper (sm_90a) kernels of the u32 toeplitz ("mxu") blind
// rotation: K1 build_tables, K2 rotdig, K3 rotdig_recombine. They replace
// the Pallas kernels of concrete_tpu/core/bootstrap_mxu.py and compute the
// same bits; the plain PyTorch versions beside the wrappers
// (concrete_tpu_torch/core/bootstrap_mxu.py) define what each one returns.
//
// Torus values arrive as int32 tensors holding u32 bit patterns; every
// torus operation here is on uint32_t, whose wrap is defined (signed
// overflow is not). Only the sub-digit split works in int32, as the JAX
// code does, on values far from overflow.
//
// Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmxu_kernels.so mxu_kernels.cu
// Each extern "C" entry point launches one kernel on the given stream and
// returns cudaGetLastError().

#include <cstddef>
#include <cstdint>

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
__device__ __forceinline__ void emit_digits(int8_t* d8_row,
                                            const uint32_t diff[4], int ki,
                                            int ks1, int n, int c0,
                                            int base_log, int level,
                                            int n_sub) {
  const int non_rep = 32 - base_log * level;  // in [0, 31]
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
      uint32_t st = state[q] >> base_log;
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
// acc [k+1, B, N] u32, a_hat [B] i32 -> d8 [B, R*N] i8, R = level*n_sub*(k+1).
// One block per (lane b, polynomial ki); the polynomial sits in shared
// memory (N <= 4096 words = 16 KB) and each thread gathers its rotated
// coefficients from it, in place of the TPU kernel's barrel of static
// rolls (which existed only because its compiler hung on dynamic rolls).
// Bound on the card: HBM traffic, 4 bytes read and R/(k+1) bytes written
// per coefficient; the digit loop is a few dozen integer ops. Design: the
// acc row is read once, 16 bytes a thread, and the digits leave as packed
// 4-byte stores, so a warp writes 128 contiguous bytes.
__global__ void rotdig_kernel(const uint32_t* __restrict__ acc,
                              const int32_t* __restrict__ a_hat,
                              int8_t* __restrict__ d8, int batch, int ks1,
                              int n, int base_log, int level, int n_sub) {
  extern __shared__ uint32_t row[];
  const int b = blockIdx.x;
  const int ki = blockIdx.y;
  const uint32_t* src = acc + (static_cast<size_t>(ki) * batch + b) * n;
  for (int c0 = threadIdx.x * 4; c0 < n; c0 += blockDim.x * 4) {
    *reinterpret_cast<uint4*>(row + c0) =
        *reinterpret_cast<const uint4*>(src + c0);
  }
  __syncthreads();
  const size_t d8_cols = static_cast<size_t>(level) * n_sub * ks1 * n;
  rotdig_row(row, a_hat[b], d8 + b * d8_cols, ki, ks1, n, base_log, level,
             n_sub);
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
  extern __shared__ uint32_t row[];
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

// K1 build_tables. Replaces
// concrete_tpu/core/bootstrap_mxu.py:_build_tables_pallas.
// rings [R, k+1, 2N] u32 -> rhs [R*N, (k+1)*n_kept*N] i8: entry
// (blk*N + r, (kj*n_kept + li)*N + c) = byte (limb_drop + li) of
// ring[blk, kj][(c - r) mod 2N]. One block per output row; each thread
// makes 4 consecutive output bytes from 4 consecutive ring words.
// Bound on the card: pure HBM write bandwidth (the RHS is R*N x
// (k+1)*n_kept*N bytes, 13 MB a step at TPU128); a ring is at most 32 KB
// and is read N times from L1/L2, not from HBM. Design: every thread stores
// one 4-byte word, so each warp writes 128 contiguous bytes; the caller
// keeps one output buffer for the whole blind rotation.
__global__ void build_tables_kernel(const uint32_t* __restrict__ rings,
                                    int8_t* __restrict__ out, int ks1, int n,
                                    int log2n, int n_kept, int limb_drop) {
  const int rowi = blockIdx.x;
  const int blk = rowi >> log2n;
  const int r = rowi & (n - 1);
  const int words = (ks1 * n_kept * n) >> 2;
  const uint32_t* ring_blk =
      rings + static_cast<size_t>(blk) * ks1 * 2 * n;
  uint32_t* out_row = reinterpret_cast<uint32_t*>(
      out + static_cast<size_t>(rowi) * ks1 * n_kept * n);
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int c0 = (w << 2) & (n - 1);
    const int t = (w << 2) >> log2n;  // kj * n_kept + li
    const int kj = t / n_kept;
    const int shift = 8 * (limb_drop + t - kj * n_kept);
    const uint32_t* ring = ring_blk + static_cast<size_t>(kj) * 2 * n;
    uint32_t packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t idx =
          (static_cast<uint32_t>(c0 + q) - static_cast<uint32_t>(r)) & wrap;
      packed |= ((__ldg(ring + idx) >> shift) & 0xFFu) << (8 * q);
    }
    out_row[w] = packed;
  }
}

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

int row_threads(int n) {  // one thread per 4 coefficients, at most 1024
  const int t = n / 4;
  return t < 1024 ? t : 1024;
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ctt_build_tables(const void* rings, void* out, int r_blocks, int ks1,
                     int n, int n_kept, int limb_drop, void* stream) {
  const int words = (ks1 * n_kept * n) / 4;
  const int threads = words < 256 ? words : 256;
  build_tables_kernel<<<r_blocks * n, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rings), static_cast<int8_t*>(out), ks1, n,
      log2_int(n), n_kept, limb_drop);
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

}  // extern "C"
