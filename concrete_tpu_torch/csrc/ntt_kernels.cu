// Hand-written Hopper (sm_90a) kernel of the exact-NTT ("ntt") blind
// rotation: K9 ntt_cmux, one whole CMux step. It replaces the Pallas kernel
// of concrete_tpu/ops/pallas_cmux.py:make_cmux_kernel and computes the same
// bits; the plain PyTorch version beside the wrapper
// (concrete_tpu_torch/core/bootstrap_ntt.py:ntt_cmux_plain) defines what it
// returns.
//
// What bounds it: integer instructions. Per row and step it runs 2*l*(k+1)
// forward and 2*(k+1) inverse negacyclic NTTs of N words, the pointwise MAC
// and the Garner step, about 1.6e9 instructions at TPU128 B=2048 against
// 21 MB of acc traffic; chip_smoke.int_ops_s charges the fewest of them by
// pipe (multiplies and compares at 64 lanes/clk/SM each, all within 128 of
// issue). The design, against the causes that held the first kernel at
// ~13% of that bound:
//  1. One digit pass per coefficient: the rotated difference X^a acc_i -
//     acc_i is gathered once and its carry chain run once, yielding all l
//     digits; the twisted residues of both primes for every level go
//     straight into shared memory (2*l polynomials per input polynomial).
//  2. Many polynomials per barrier, several stages per exchange: stage s of
//     every polynomial the block holds runs between the same two barriers,
//     and each thread takes 16 coefficients through 4 stages in registers
//     (radix-16 passes, the last one shorter: ceil(log2 N / 4) barriers a
//     transform set, 2 + 2 at N = 256 where the first kernel had 9 per
//     polynomial). The order is ntt.forward_stacked's DIF (bit-reversed
//     spectra, as bsk_to_ntt stores the key) and ntt.inverse_stacked's.
//     Each polynomial has a pad word after every 8, which puts the strided
//     exchanges of the late stages on distinct banks.
//  3. MAC in registers: a thread owns spectrum positions and sums, per
//     prime and output column, over every (level, i), the raw products of
//     two slots at a time (< 2p^2) through one lazy REDC (< 2p) into a
//     64-bit register, one REDC at the end; no read-modify-write of shared
//     memory. The GGSW words are read coalesced along N.
//  4. Several batch rows per block (bootstrap_ntt.block_geometry): each
//     GGSW word read from L2 serves every row of the block.
//  5. Cheaper products: the REDC sum a*b + m*p is one 64-bit multiply-add
//     (IMAD.WIDE) whose high word is the result, with no carry test.
//     Residues stay canonical in [0, p) through the transforms.
// Because the MAC's REDC divides by R once more, the host's untwist table
// carries psi^-i * N^-1 * R (bootstrap_ntt._host_tables).
//
// Torus values arrive as int32 tensors holding u32 bit patterns; residues
// mod the two CRT primes p < 2^31 are uint32_t.
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
constexpr int kThreads = 256;
constexpr int kMaxRows = 4;   // batch rows per block, at most
constexpr int kMaxCols = 5;   // output polynomials per block, at most
constexpr int kRadixLog = 4;  // stages per shared-memory exchange, at most
// constants[]: p0, p1, n'0, n'1, inv(p0)*R mod p1, the mixed-radix digits
// t1, t2 of ceil(p0*p1/2), p0*p1 mod 2^32
enum { kP0, kP1, kNp0, kNp1, kGarner, kHalf1, kHalf2, kMModQ };
// tables[kind][prime][N]: twist psi^i R^2, untwist psi^-i N^-1 R, forward
// and inverse twiddles of every stage (stage s at offset N - (N >> s))
enum { kTwist, kUntwist, kWFwd, kWInv };

// a*b*R^-1 mod p, lazily in [0, 2p) for a*b < p*2^32: the REDC sum
// a*b + m*p (< 2^63 + 2^62) is one wide multiply-add, its low word 0.
__device__ __forceinline__ uint32_t mont_lazy(uint32_t a, uint32_t b,
                                              uint32_t p, uint32_t np) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(ab) * np;
  return static_cast<uint32_t>((ab + static_cast<uint64_t>(m) * p) >> 32);
}

// The reductions below take the unsigned minimum of t and t - p (or t + p):
// for t < 2p exactly one of the two lies in [0, p), and the other wraps
// above it (p > 2^30), so each costs an add and a min.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t np) {
  const uint32_t t = mont_lazy(a, b, p, np);
  return min(t, t - p);
}

// s*R^-1 mod p, canonical, for s a sum of at most p lazy REDCs (each
// < 2p): s + m*p < 2^64 and (s + m*p) / 2^32 < 2p
__device__ __forceinline__ uint32_t redc64(uint64_t s, uint32_t p,
                                           uint32_t np) {
  const uint32_t m = static_cast<uint32_t>(s) * np;
  const uint32_t t =
      static_cast<uint32_t>((s + static_cast<uint64_t>(m) * p) >> 32);
  return min(t, t - p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t s = a + b;
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  const uint32_t d = a - b;
  return min(d, d + p);
}

// Shared memory holds each polynomial with one pad word after every 8
// (stride N + N/8): the strided exchanges of the radix passes (stride d < 32)
// then fall on distinct banks.
__device__ __forceinline__ int pad(int c) { return c + (c >> 3); }

// One pass of R <= 4 stages over `polys` padded polynomials at `x`, the
// first `split` of the first prime: every thread takes groups of 2^R
// coefficients at stride d through R stages in registers. Forward (DIF,
// ntt.forward_stacked) runs stages s0 .. s0+R-1 with d = N >> (s0 + R);
// inverse (ntt.inverse_stacked) runs stages s0, s0-1, .., s0-R+1 with
// d = N >> (s0 + 1).
template <bool kInverse, int R>
__device__ __forceinline__ void radix_pass(uint32_t* x, int polys, int split,
                                           int n, int log2n, int s0,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* cst) {
  constexpr int g = 1 << R;
  const int lg_d = kInverse ? log2n - 1 - s0 : log2n - s0 - R;
  const int d = 1 << lg_d;
  const int per_poly = n >> R;
  const int stride = pad(n);
  for (int u = threadIdx.x; u < polys * per_poly; u += blockDim.x) {
    const int q = u >> (log2n - R);
    const int idx = u & (per_poly - 1);
    const int j = idx & (d - 1);
    const int pi = q < split ? 0 : 1;
    const uint32_t p = cst[kP0 + pi];
    const uint32_t np = cst[kNp0 + pi];
    const uint32_t* w = tw + pi * n;
    uint32_t* base = x + q * stride;
    const int off = ((idx >> lg_d) << (lg_d + R)) + j;
    uint32_t v[g];
#pragma unroll
    for (int t = 0; t < g; ++t) v[t] = base[pad(off + t * d)];
#pragma unroll
    for (int st = 0; st < R; ++st) {
      // forward: stage s0+st, pairs (t, t+half) with half = g >> (st+1);
      // inverse: stage s0-st, half = 1 << st
      const int half = kInverse ? 1 << st : g >> (st + 1);
      const int s = kInverse ? s0 - st : s0 + st;
      const uint32_t* ws = w + (n - (n >> s));
#pragma unroll
      for (int t = 0; t < g; ++t) {
        if (!(t & half)) {
          const uint32_t wt = __ldg(ws + j + (t & (half - 1)) * d);
          const uint32_t a = v[t], b = v[t + half];
          if (kInverse) {
            const uint32_t vb = mont_mul(b, wt, p, np);
            v[t] = add_mod(a, vb, p);
            v[t + half] = sub_mod(a, vb, p);
          } else {
            v[t] = add_mod(a, b, p);
            v[t + half] = mont_mul(sub_mod(a, b, p), wt, p, np);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < g; ++t) base[pad(off + t * d)] = v[t];
  }
}

// The transforms of `polys` padded polynomials, stage-major, one barrier
// before each pass of up to 4 stages and one after the last. Forward: DIF,
// natural order in, bit-reversed Montgomery spectra out; inverse: back.
template <bool kInverse>
__device__ void ntts(uint32_t* x, int polys, int split, int n, int log2n,
                     const uint32_t* __restrict__ tables,
                     const uint32_t* cst) {
  const uint32_t* tw = tables + (kInverse ? kWInv : kWFwd) * kPrimes * n;
  for (int done = 0; done < log2n; done += kRadixLog) {
    const int r = min(kRadixLog, log2n - done);
    const int s0 = kInverse ? log2n - 1 - done : done;
    __syncthreads();
    if (r == 4) {
      radix_pass<kInverse, 4>(x, polys, split, n, log2n, s0, tw, cst);
    } else if (r == 3) {
      radix_pass<kInverse, 3>(x, polys, split, n, log2n, s0, tw, cst);
    } else if (r == 2) {
      radix_pass<kInverse, 2>(x, polys, split, n, log2n, s0, tw, cst);
    } else {
      radix_pass<kInverse, 1>(x, polys, split, n, log2n, s0, tw, cst);
    }
  }
  __syncthreads();
}

// K9 ntt_cmux. Replaces concrete_tpu/ops/pallas_cmux.py:make_cmux_kernel.
// acc [k+1, B, N] u32, a_hat [B] i32 (read mod 2N), ggsw [2, l, k+1, k+1,
// N] u32 Montgomery spectra (bit-reversed, core/ggsw.bsk_to_ntt) -> out
// [k+1, B, N] = acc + the two-prime CRT recombination of
//   sum_{lev, i} NTT^-1(NTT(digit_lev(X^a acc_i - acc_i)) * ggsw[lev, i, j])
// for each output polynomial j.
// Block (row group, column group): ROWS batch rows (fewer in the last
// group) and output columns [j0, j0 + nj), nj <= NJ. Digit polynomials are numbered q =
// (prime*(k+1) + i)*l + lev, 2*l*(k+1) of them, prime-major; the block
// takes them `group` at a time (all at once unless N is large). Shared
// memory, padded polynomials: the column spectra spec[prime][row][nj]
// (canonical partial sums, R^-1-scaled) and the group's digit polynomials
// dig[slot][row].
template <int NJ, int ROWS, int THREADS>
__global__ void __launch_bounds__(THREADS)
    ntt_cmux_kernel(const uint32_t* __restrict__ acc,
                    const int32_t* __restrict__ a_hat,
                    const uint32_t* __restrict__ ggsw,
                    const uint32_t* __restrict__ tables,
                    const uint32_t* __restrict__ constants,
                    uint32_t* __restrict__ out, int batch, int ks1, int n,
                    int log2n, int level, int base_log, int cols, int group) {
  constexpr int rows = ROWS;
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t cst[8];
  const int groups = (ks1 + cols - 1) / cols;
  const int b0 = (blockIdx.x / groups) * rows;
  const int j0 = (blockIdx.x % groups) * cols;
  const int nj = min(cols, ks1 - j0);
  const int nrows = min(rows, batch - b0);
  const int per_prime = ks1 * level;  // digit polynomials of one prime
  const int stride = pad(n);
  uint32_t* spec = smem;                                 // [2][rows][nj]
  uint32_t* dig = smem + kPrimes * rows * cols * stride;  // [group][rows]
  if (threadIdx.x < 8) cst[threadIdx.x] = constants[threadIdx.x];
  __syncthreads();

  const int non_rep = 32 - base_log * level;
  const uint32_t mask = (1u << base_log) - 1u;
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  for (int q0 = 0; q0 < kPrimes * per_prime; q0 += group) {
    const int gq = min(group, kPrimes * per_prime - q0);
    // 1. the digits: one carry chain per (row, i, coefficient), every
    // level's residue of each prime in the group twisted into dig
    for (int ri = 0; ri < nrows * ks1; ++ri) {
      const int i = ri / nrows;
      const int r = ri - i * nrows;
      const int qa = i * level - q0;  // slot of (prime 0, i, lev 0)
      const int qb = qa + per_prime;  // slot of (prime 1, i, lev 0)
      if ((qa + level <= 0 || qa >= gq) && (qb + level <= 0 || qb >= gq)) {
        continue;
      }
      const int b = b0 + r;
      const uint32_t* row = acc + (static_cast<size_t>(i) * batch + b) * n;
      const uint32_t a = static_cast<uint32_t>(a_hat[b]);
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const uint32_t t = (static_cast<uint32_t>(c) - a) & wrap;
        const uint32_t v = __ldg(row + (t & static_cast<uint32_t>(n - 1)));
        uint32_t x =
            (t >= static_cast<uint32_t>(n) ? 0u - v : v) - __ldg(row + c);
        // closest_representable, then decompose_levels' carry rule, level
        // l first (pallas_cmux.py:158-174)
        if (non_rep > 0) {
          const uint32_t msb = (x >> (non_rep - 1)) & 1u;
          x = ((x >> non_rep) + msb) << non_rep;
        }
        uint32_t state = x >> non_rep;
        for (int lev = level - 1; lev >= 0; --lev) {
          const uint32_t res = state & mask;
          state >>= base_log;
          uint32_t carry = ((res - 1u) | state) & res;
          carry >>= base_log - 1;
          state += carry;
          const int32_t digit =
              static_cast<int32_t>(res - (carry << base_log));
#pragma unroll
          for (int pi = 0; pi < kPrimes; ++pi) {
            const int q = (pi ? qb : qa) + lev;
            if (q >= 0 && q < gq) {
              const uint32_t p = cst[kP0 + pi];
              const uint32_t res_p = static_cast<uint32_t>(
                  digit < 0 ? digit + static_cast<int32_t>(p) : digit);
              dig[(q * nrows + r) * stride + pad(c)] = mont_mul(
                  res_p, __ldg(tables + (kTwist * kPrimes + pi) * n + c), p,
                  cst[kNp0 + pi]);
            }
          }
        }
      }
    }
    // 2. every digit polynomial of every row of the block, stage by stage
    const int first1 = min(gq, max(0, per_prime - q0));  // first prime-1 slot
    ntts<false>(dig, gq * nrows, first1 * nrows, n, log2n, tables, cst);

    // 3. the MAC: per owned position, prime and column, one 64-bit sum of
    // lazy REDCs over the group's (lev, i), one final REDC; each GGSW word
    // is read once for all rows of the block
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int pc = pad(c);
#pragma unroll
      for (int pi = 0; pi < kPrimes; ++pi) {
        const uint32_t p = cst[kP0 + pi];
        const uint32_t np = cst[kNp0 + pi];
        const int q_lo = max(0, pi * per_prime - q0);
        const int q_hi = min(gq, (pi + 1) * per_prime - q0);
        if (q_lo >= q_hi) continue;
        uint64_t sum[ROWS][NJ];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) sum[r][jj] = 0;
        // two slots at a time: the raw products of a pair (each < p^2,
        // together < 2p^2 < 2^63) take one lazy REDC
        auto fetch = [&](int q, uint32_t* gv) {
          const int il = q + q0 - pi * per_prime;  // i*level + lev
          const int i = il / level;
          const int lev = il - i * level;
          const uint32_t* gp =
              ggsw + ((static_cast<size_t>(pi) * level + lev) * ks1 + i) *
                         ks1 * n + static_cast<size_t>(j0) * n + c;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            gv[jj] = jj < nj ? __ldg(gp + jj * n) : 0u;
          }
        };
        for (int q = q_lo; q < q_hi; q += 2) {
          const bool pair = q + 1 < q_hi;
          uint32_t gv[NJ], gw[NJ];
          fetch(q, gv);
          if (pair) {
            fetch(q + 1, gw);
          } else {
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) gw[jj] = 0u;
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < nrows) {
              const uint32_t xv = dig[(q * nrows + r) * stride + pc];
              const uint32_t xw =
                  pair ? dig[((q + 1) * nrows + r) * stride + pc] : 0u;
#pragma unroll
              for (int jj = 0; jj < NJ; ++jj) {
                const uint64_t raw = static_cast<uint64_t>(xv) * gv[jj] +
                                     static_cast<uint64_t>(xw) * gw[jj];
                const uint32_t m = static_cast<uint32_t>(raw) * np;
                sum[r][jj] += static_cast<uint32_t>(
                    (raw + static_cast<uint64_t>(m) * p) >> 32);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            if (r < nrows && jj < nj) {
              uint32_t* sp =
                  spec + ((pi * nrows + r) * nj + jj) * stride + pc;
              const uint32_t v = redc64(sum[r][jj], p, np);
              *sp = q0 + q_lo == pi * per_prime ? v : add_mod(*sp, v, p);
            }
          }
        }
      }
    }
    __syncthreads();  // the next group's digits reuse dig
  }

  // 4. the inverse transforms of every row's column spectra
  ntts<true>(spec, kPrimes * nrows * nj, nrows * nj, n, log2n, tables, cst);

  // 5. untwist, Garner (pallas_cmux.py:199-211) and the accumulate
  const uint32_t p0 = cst[kP0], p1 = cst[kP1];
  const uint32_t np0 = cst[kNp0], np1 = cst[kNp1];
  const uint32_t t1 = cst[kHalf1], t2 = cst[kHalf2];
  for (int rj = 0; rj < nrows * nj; ++rj) {
    const int r = rj / nj;
    const int jj = rj - r * nj;
    const uint32_t* s0 = spec + rj * stride;
    const uint32_t* s1 = spec + (nrows * nj + rj) * stride;
    const size_t row = (static_cast<size_t>(j0 + jj) * batch + b0 + r) * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const uint32_t x1 = mont_mul(
          s0[pad(c)], __ldg(tables + (kUntwist * kPrimes) * n + c), p0, np0);
      const uint32_t r2 = mont_mul(
          s1[pad(c)], __ldg(tables + (kUntwist * kPrimes + 1) * n + c), p1,
          np1);
      const uint32_t x1m = x1 >= p1 ? x1 - p1 : x1;
      const uint32_t x2 =
          mont_mul(sub_mod(r2, x1m, p1), cst[kGarner], p1, np1);
      uint32_t v = x1 + p0 * x2;
      const bool ge = (x2 > t2) || (x2 == t2 && x1 >= t1);
      v -= ge ? cst[kMModQ] : 0u;
      out[row + c] = acc[row + c] + v;
    }
  }
}

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <int NJ, int ROWS, int THREADS>
int launch(const void* acc, const void* a_hat, const void* ggsw,
           const void* tables, const void* constants, void* out, int batch,
           int ks1, int n, int level, int base_log, int cols, int group,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ROWS) *
                      (kPrimes * cols + group) * (n + n / 8) *
                      sizeof(uint32_t);
  static bool raised = false;  // the 227 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_cmux_kernel<NJ, ROWS, THREADS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448 - 8 * static_cast<int>(sizeof(uint32_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const int groups = (ks1 + cols - 1) / cols;
  const int blocks = (batch + ROWS - 1) / ROWS * groups;
  ntt_cmux_kernel<NJ, ROWS, THREADS><<<blocks, THREADS, smem, stream>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<const uint32_t*>(ggsw),
      static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(constants), static_cast<uint32_t*>(out),
      batch, ks1, n, log2_int(n), level, base_log, cols, group);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for `rows` rows a block, NJ columns at most
template <int NJ>
int launch_rows(int rows, const void* acc, const void* a_hat,
                const void* ggsw, const void* tables, const void* constants,
                void* out, int batch, int ks1, int n, int level, int base_log,
                int cols, int group, cudaStream_t stream) {
#define CTT_LAUNCH(R)                                                      \
  launch<NJ, R, kThreads>(acc, a_hat, ggsw, tables, constants, out, batch, \
                          ks1, n, level, base_log, cols, group, stream)
  switch (rows) {
    case 1:
      return CTT_LAUNCH(1);
    case 2:
      return CTT_LAUNCH(2);
    case 3:
      return CTT_LAUNCH(3);
    default:
      return CTT_LAUNCH(4);
  }
#undef CTT_LAUNCH
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// cols (output polynomials per block, <= 5), group (digit polynomials
// transformed together) and rows (batch rows per block, <= 4) come from
// bootstrap_ntt.block_geometry. One row a block at N >= 8192 (at most two
// columns there) takes 1024 threads, else kThreads.
int ctt_ntt_cmux(const void* acc, const void* a_hat, const void* ggsw,
                 const void* tables, const void* constants, void* out,
                 int batch, int ks1, int n, int level, int base_log,
                 int cols, int group, int rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nj = cols < ks1 ? cols : ks1;
  if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols ||
      group < 1 || level < 1 || level * base_log > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 1 && n >= 8192 && nj <= 2) {
    return nj == 1 ? launch<1, 1, 1024>(acc, a_hat, ggsw, tables, constants,
                                        out, batch, ks1, n, level, base_log,
                                        cols, group, s)
                   : launch<2, 1, 1024>(acc, a_hat, ggsw, tables, constants,
                                        out, batch, ks1, n, level, base_log,
                                        cols, group, s);
  }
  switch (nj) {
    case 1:
      return launch_rows<1>(rows, acc, a_hat, ggsw, tables, constants, out,
                            batch, ks1, n, level, base_log, cols, group, s);
    case 2:
      return launch_rows<2>(rows, acc, a_hat, ggsw, tables, constants, out,
                            batch, ks1, n, level, base_log, cols, group, s);
    case 3:
      return launch_rows<3>(rows, acc, a_hat, ggsw, tables, constants, out,
                            batch, ks1, n, level, base_log, cols, group, s);
    case 4:
      return launch_rows<4>(rows, acc, a_hat, ggsw, tables, constants, out,
                            batch, ks1, n, level, base_log, cols, group, s);
    case 5:
      return launch_rows<5>(rows, acc, a_hat, ggsw, tables, constants, out,
                            batch, ks1, n, level, base_log, cols, group, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
