// Hand-written Hopper (sm_90a) kernel of the exact-NTT ("ntt") blind
// rotation: K9 ntt_cmux, one whole CMux step. It replaces the Pallas kernel
// of concrete_tpu/ops/pallas_cmux.py:make_cmux_kernel and computes the same
// bits; the plain PyTorch version beside the wrapper
// (concrete_tpu_torch/core/bootstrap_ntt.py:ntt_cmux_plain) defines what it
// returns.
//
// Torus values arrive as int32 tensors holding u32 bit patterns; residues
// mod the two CRT primes p < 2^31 are uint32_t in [0, p). Every product is a
// Montgomery product (R = 2^32) on the card's native wide multiply
// (mul.wide.u32 and __umulhi), where the TPU kernel built one from 16-bit
// halves; the reduction is the JAX code's REDC step for step.
//
// Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libntt_kernels.so ntt_kernels.cu
// The extern "C" entry point launches the kernel on the given stream and
// returns the CUDA error code.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPrimes = 2;
// constants[]: p0, p1, n'0, n'1, inv(p0)*R mod p1, the mixed-radix digits
// t1, t2 of ceil(p0*p1/2), p0*p1 mod 2^32
enum { kP0, kP1, kNp0, kNp1, kGarner, kHalf1, kHalf2, kMModQ };
// tables[kind][prime][N]: twist psi^i R^2, untwist psi^-i N^-1, forward and
// inverse twiddles of every stage (stage s at offset N - (N >> s))
enum { kTwist, kUntwist, kWFwd, kWInv };

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t np) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(ab);
  const uint32_t m = lo * np;
  const uint32_t t = static_cast<uint32_t>(ab >> 32) + __umulhi(m, p) +
                     (lo != 0u ? 1u : 0u);  // < 2p < 2^32
  return t >= p ? t - p : t;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return a >= b ? a - b : a + (p - b);
}

// Signed gadget digit `lev` (0 = level 1, the most significant) of one
// torus value: closest_representable, then the carry rule of
// decompose_levels, level l first, as pallas_cmux.py:158-174. base_log*level
// lies in [1, 32] and base_log <= 31 (the digits stay below the primes).
__device__ __forceinline__ int32_t gadget_digit(uint32_t v, int lev,
                                                int level, int base_log) {
  const int non_rep = 32 - base_log * level;
  if (non_rep > 0) {
    const uint32_t msb = (v >> (non_rep - 1)) & 1u;
    v = ((v >> non_rep) + msb) << non_rep;
  }
  uint32_t state = v >> non_rep;
  const uint32_t mask = (1u << base_log) - 1u;
  int32_t digit = 0;
  for (int step = 0; step < level - lev; ++step) {
    const uint32_t res = state & mask;
    state >>= base_log;
    uint32_t carry = ((res - 1u) | state) & res;
    carry >>= base_log - 1;
    state += carry;
    digit = static_cast<int32_t>(res - (carry << base_log));
  }
  return digit;
}

// In-place forward negacyclic NTT of one polynomial in shared memory
// (ntt.forward_stacked): twisted residues in natural order -> Montgomery
// spectrum in bit-reversed order. A decimation in frequency: at stage s,
// butterfly t pairs x[i0], x[i0 + m] with m = N >> (s+1), i0 = (t / m) * 2m
// + t % m, and its twiddle w_s[t % m].
__device__ void forward_ntt(uint32_t* x, const uint32_t* __restrict__ w,
                            int n, int log2n, uint32_t p, uint32_t np) {
  for (int s = 0; s < log2n; ++s) {
    const int lg_m = log2n - 1 - s;
    const int m = 1 << lg_m;
    const uint32_t* ws = w + (n - (n >> s));
    __syncthreads();
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      const int j = t & (m - 1);
      const int i0 = ((t >> lg_m) << (lg_m + 1)) + j;
      const uint32_t a = x[i0];
      const uint32_t b = x[i0 + m];
      x[i0] = add_mod(a, b, p);
      x[i0 + m] = mont_mul(sub_mod(a, b, p), __ldg(ws + j), p, np);
    }
  }
  __syncthreads();
}

// In-place inverse NTT of `polys` = 2*cols polynomials at once
// (ntt.inverse_stacked), polynomial q of prime q / cols: bit-reversed
// Montgomery spectra -> plain residues, untwisted and divided by N.
__device__ void inverse_ntts(uint32_t* spec, int polys, int cols,
                             const uint32_t* __restrict__ tables,
                             const uint32_t* __restrict__ cst, int n,
                             int log2n) {
  const int half = n / 2;
  for (int s = log2n - 1; s >= 0; --s) {
    const int lg_m = log2n - 1 - s;
    const int m = 1 << lg_m;
    __syncthreads();
    for (int u = threadIdx.x; u < polys * half; u += blockDim.x) {
      const int q = u >> (log2n - 1);
      const int t = u & (half - 1);
      const int pi = q >= cols ? 1 : 0;
      const uint32_t p = cst[kP0 + pi];
      const uint32_t np = cst[kNp0 + pi];
      const uint32_t* ws =
          tables + (kWInv * kPrimes + pi) * n + (n - (n >> s));
      uint32_t* x = spec + q * n;
      const int j = t & (m - 1);
      const int i0 = ((t >> lg_m) << (lg_m + 1)) + j;
      const uint32_t a = x[i0];
      const uint32_t v = mont_mul(x[i0 + m], __ldg(ws + j), p, np);
      x[i0] = add_mod(a, v, p);
      x[i0 + m] = sub_mod(a, v, p);
    }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < polys * n; u += blockDim.x) {
    const int q = u >> log2n;
    const int c = u & (n - 1);
    const int pi = q >= cols ? 1 : 0;
    spec[u] = mont_mul(spec[u],
                       __ldg(tables + (kUntwist * kPrimes + pi) * n + c),
                       cst[kP0 + pi], cst[kNp0 + pi]);
  }
  __syncthreads();
}

// K9 ntt_cmux. Replaces concrete_tpu/ops/pallas_cmux.py:make_cmux_kernel.
// acc [k+1, B, N] u32, a_hat [B] i32 (read mod 2N), ggsw [2, l, k+1, k+1,
// N] u32 Montgomery spectra (bit-reversed, core/ggsw.bsk_to_ntt) -> out
// [k+1, B, N] = acc + the two-prime CRT recombination of
//   sum_{lev, i} NTT^-1(NTT(digit_lev(X^a acc_i - acc_i)) * ggsw[lev, i, j])
// for each output polynomial j.
// Block (b, g): batch row b and output columns [g*cols, g*cols + nj); the
// block's shared memory holds one work polynomial and the 2*nj spectra it
// accumulates, (2*nj + 1)*N words (dynamic; up to 192 KB at N = 16384).
// Per (input polynomial i, level, prime) the block writes the twisted digit
// residues into the work polynomial (the rotation is a signed gather from
// acc, which stays in L1/L2, in place of the TPU kernel's barrel of static
// rolls), transforms it in place, and multiply-accumulates it against the
// GGSW spectra (the step's 73-102 KB slice, read by every block, stays in
// L2). Then it inverse-transforms its spectra, recombines the two primes
// with Garner's algorithm (pallas_cmux.py:199-211) and adds acc.
// Bound on the card: integer operations, about 1.3e8 Montgomery products a
// step at TPU128 B=2048 against 21 MB of acc traffic; the design keeps every
// transform in shared memory so that the acc rows, the GGSW slice and the
// twiddles are the only device-memory reads. Where the columns split over
// several blocks (N = 16384, or N = 8192 with k >= 3), each block redoes
// the forward transforms of the digits.
__global__ void __launch_bounds__(1024)
    ntt_cmux_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ a_hat,
                    const uint32_t* __restrict__ ggsw,
                    const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ constants,
                    uint32_t* __restrict__ out, int batch, int ks1, int n,
                    int log2n, int level, int base_log, int cols) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t cst[8];
  const int groups = (ks1 + cols - 1) / cols;
  const int b = blockIdx.x / groups;
  const int j0 = (blockIdx.x - b * groups) * cols;
  const int nj = min(cols, ks1 - j0);
  uint32_t* work = smem;
  uint32_t* spec = smem + n;  // [prime][jj][N]
  if (threadIdx.x < 8) cst[threadIdx.x] = constants[threadIdx.x];
  for (int u = threadIdx.x; u < kPrimes * nj * n; u += blockDim.x) {
    spec[u] = 0u;
  }
  __syncthreads();

  const int32_t a = a_hat[b];
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  for (int i = 0; i < ks1; ++i) {
    const uint32_t* row = acc + (static_cast<size_t>(i) * batch + b) * n;
    for (int lev = 0; lev < level; ++lev) {
      for (int pi = 0; pi < kPrimes; ++pi) {
        const uint32_t p = cst[kP0 + pi];
        const uint32_t np = cst[kNp0 + pi];
        const uint32_t* twist = tables + (kTwist * kPrimes + pi) * n;
        for (int c = threadIdx.x; c < n; c += blockDim.x) {
          const uint32_t t = (static_cast<uint32_t>(c) -
                              static_cast<uint32_t>(a)) & wrap;
          const uint32_t v = __ldg(row + (t & static_cast<uint32_t>(n - 1)));
          const uint32_t rot = t >= static_cast<uint32_t>(n) ? 0u - v : v;
          const int32_t d = gadget_digit(rot - __ldg(row + c), lev, level,
                                         base_log);
          const uint32_t r = static_cast<uint32_t>(
              d < 0 ? d + static_cast<int32_t>(p) : d);
          work[c] = mont_mul(r, __ldg(twist + c), p, np);
        }
        forward_ntt(work, tables + (kWFwd * kPrimes + pi) * n, n, log2n, p,
                    np);
        const uint32_t* g =
            ggsw + ((static_cast<size_t>(pi) * level + lev) * ks1 + i) *
                       ks1 * n;
        for (int c = threadIdx.x; c < n; c += blockDim.x) {
          const uint32_t x = work[c];
          for (int jj = 0; jj < nj; ++jj) {
            uint32_t* s = spec + (pi * nj + jj) * n + c;
            *s = add_mod(*s,
                         mont_mul(x, __ldg(g + (j0 + jj) * n + c), p, np), p);
          }
        }
        __syncthreads();  // the next digit polynomial reuses `work`
      }
    }
  }

  inverse_ntts(spec, kPrimes * nj, nj, tables, cst, n, log2n);

  const uint32_t p0 = cst[kP0], p1 = cst[kP1], np1 = cst[kNp1];
  const uint32_t t1 = cst[kHalf1], t2 = cst[kHalf2];
  for (int u = threadIdx.x; u < nj * n; u += blockDim.x) {
    const int jj = u >> log2n;
    const int c = u & (n - 1);
    const uint32_t x1 = spec[jj * n + c];
    const uint32_t r2 = spec[(nj + jj) * n + c];
    const uint32_t x1m = x1 >= p1 ? x1 - p1 : x1;
    const uint32_t x2 = mont_mul(sub_mod(r2, x1m, p1), cst[kGarner], p1, np1);
    uint32_t v = x1 + p0 * x2;
    const bool ge = (x2 > t2) || (x2 == t2 && x1 >= t1);
    v -= ge ? cst[kMModQ] : 0u;
    const size_t off = (static_cast<size_t>(j0 + jj) * batch + b) * n + c;
    out[off] = acc[off] + v;
  }
}

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ctt_ntt_cmux(const void* acc, const void* a_hat, const void* ggsw,
                 const void* tables, const void* constants, void* out,
                 int batch, int ks1, int n, int level, int base_log,
                 int cols, void* stream) {
  const int nj = cols < ks1 ? cols : ks1;
  const int groups = (ks1 + nj - 1) / nj;
  const size_t smem = static_cast<size_t>(2 * nj + 1) * n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_cmux_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = n / 2;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  ntt_cmux_kernel<<<batch * groups, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<const uint32_t*>(ggsw),
      static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(constants), static_cast<uint32_t*>(out),
      batch, ks1, n, log2_int(n), level, base_log, nj);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
