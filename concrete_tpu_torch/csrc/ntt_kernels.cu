// Hand-written Hopper (sm_90a) kernels of the exact-NTT ("ntt") blind
// rotation: K9 ntt_cmux, one whole CMux step. They replace the Pallas kernel
// of concrete_tpu/ops/pallas_cmux.py:make_cmux_kernel and compute the same
// bits; the plain PyTorch version beside the wrapper
// (concrete_tpu_torch/core/bootstrap_ntt.py:ntt_cmux_plain) defines what they
// return.
//
// What bounds them: integer instructions. Per row and step a kernel runs
// 2*l*(k+1) forward and 2*(k+1) inverse negacyclic NTTs of N words, the
// pointwise MAC and the Garner step, about 1.6e9 instructions at TPU128
// B=2048 against 21 MB of acc traffic; chip_smoke.int_ops_s charges the
// fewest of them by pipe (multiplies and compares at 64 lanes/clk/SM each,
// all within 128 of issue).
//
// Two paths, chosen by shape (bootstrap_ntt.path):
//  - The warp path (ntt_cmux_warp_kernel, N = 32 T for T = 8, 16, 32: the
//    boolean presets' N = 256, 512, 1024). One batch row a block, a warp
//    per (prime, polynomial), and each polynomial the warp transforms held
//    in its registers, T words a lane, through every stage without a
//    block-wide barrier: the stages of distance >= 32 pair a lane's own
//    registers (N/32 - 1 twiddles a lane, each loaded once), the stages of
//    distance 16 .. T pair lanes (a warp shuffle trades half the
//    registers), one transpose through shared memory under __syncwarp
//    brings the last log2 T stages into registers (their twiddles the same
//    in every lane). The warp of input polynomial i runs its carry chain
//    once and writes each level's digits straight into its registers; the
//    spectra go to shared memory once; one barrier; the warp of output
//    polynomial j runs the MAC and the inverse transform in its registers;
//    a second barrier; Garner and the accumulate, coalesced. Two barriers
//    a step where the block path has ten. What bounds it: registers (a
//    polynomial and the carry chain's state, 2T words, at 80 registers a
//    thread for T <= 16 and 128 for T = 32) and shared memory, (2l + 2)(k+1)
//    polynomials a block, which together set the rows an SM holds.
//  - The block path (ntt_cmux_kernel, every other N: 16 .. 128 and
//    2048 .. 16384, where a polynomial does not fit one warp's registers,
//    and rows of more than 8 polynomials).
//    The design, against the causes that held the first kernel at ~13% of
//    the bound:
//  1. One digit pass per coefficient: the rotated difference X^a acc_i -
//     acc_i is gathered once and its carry chain run once, yielding all l
//     digits; the twisted residues of both primes for every level go
//     straight into shared memory (2*l polynomials per input polynomial).
//  2. Many polynomials per barrier, several stages per exchange: stage s of
//     every polynomial the block holds runs between the same two barriers,
//     and each thread takes 16 coefficients through 4 stages in registers
//     (radix-16 passes, the last one shorter: ceil(log2 N / 4) barriers a
//     transform set). The order is ntt.forward_stacked's DIF (bit-reversed
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
// Both: cheaper products, the REDC sum a*b + m*p is one 64-bit multiply-add
// (IMAD.WIDE) whose high word is the result, with no carry test; residues
// stay canonical in [0, p) through the transforms, so the two paths give
// the same words whatever the order of their butterflies.
// Because the MAC's REDC divides by R once more, the host's untwist table
// carries psi^-i * N^-1 * R (bootstrap_ntt._host_tables).
//
// Torus values arrive as int32 tensors holding u32 bit patterns; residues
// mod the two CRT primes p < 2^31 are uint32_t.
//
// Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libntt_kernels.so ntt_kernels.cu
// Each extern "C" entry point launches its kernel on the given stream and
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

// ---------------------------------------------------------------------------
// The warp path: N = 32 T with T = 8, 16, 32 (N = 256, 512, 1024)
// ---------------------------------------------------------------------------

constexpr int kWarpThreads = 512;  // threads a block, at most

// A warp holds a polynomial in its registers, T words a lane, in one of two
// layouts: A, c = lane + 32 t (coalesced with the device's arrays), and B,
// c = T lane + t. In shared memory a polynomial takes N + N/32 words, word c
// at wpad(c): both layouts' loads and stores then fall on 32 distinct banks.
__device__ __forceinline__ int wpad(int c) { return c + (c >> 5); }

template <int T>
__device__ __forceinline__ void store_a(uint32_t* s, const uint32_t (&v)[T],
                                        int lane) {
#pragma unroll
  for (int t = 0; t < T; ++t) s[wpad(lane + 32 * t)] = v[t];
}

template <int T>
__device__ __forceinline__ void load_a(const uint32_t* s, uint32_t (&v)[T],
                                       int lane) {
#pragma unroll
  for (int t = 0; t < T; ++t) v[t] = s[wpad(lane + 32 * t)];
}

template <int T>
__device__ __forceinline__ void store_b(uint32_t* s, const uint32_t (&v)[T],
                                        int lane) {
#pragma unroll
  for (int t = 0; t < T; ++t) s[wpad(T * lane + t)] = v[t];
}

template <int T>
__device__ __forceinline__ void load_b(const uint32_t* s, uint32_t (&v)[T],
                                       int lane) {
#pragma unroll
  for (int t = 0; t < T; ++t) v[t] = s[wpad(T * lane + t)];
}

// The butterfly of radix_pass: forward (DIF) a+b, (a-b) w; inverse (DIT)
// a + b w, a - b w.
template <bool kInverse>
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b,
                                          uint32_t w, uint32_t p,
                                          uint32_t np) {
  if (kInverse) {
    const uint32_t vb = mont_mul(b, w, p, np);
    b = sub_mod(a, vb, p);
    a = add_mod(a, vb, p);
  } else {
    const uint32_t d = sub_mod(a, b, p);
    a = add_mod(a, b, p);
    b = mont_mul(d, w, p, np);
  }
}

// The stages whose pairs lie in one lane's registers: in layout A (kA) the
// stages of distance h = 32 hr, in layout B those of distance h = hr, for
// hr = T/2 .. 1 (forward) or 1 .. T/2 (inverse). The stage of distance h has
// its twiddles at tw + N - 2h, the pair at c taking twiddle c mod h: hr
// words a lane (layout A), or hr words the same in every lane (layout B),
// each loaded once.
template <bool kInverse, bool kA, int T>
__device__ __forceinline__ void reg_stages(uint32_t (&v)[T],
                                           const uint32_t* __restrict__ tw,
                                           int lane, uint32_t p,
                                           uint32_t np) {
  constexpr int n = 32 * T;
#pragma unroll
  for (int k = 0; (1 << k) < T; ++k) {
    const int hr = kInverse ? 1 << k : T >> (k + 1);
    const uint32_t* ws =
        kA ? tw + n - 64 * hr + lane : tw + n - 2 * hr;
    uint32_t w[T / 2];
#pragma unroll
    for (int j = 0; j < hr; ++j) w[j] = __ldg(ws + (kA ? 32 * j : j));
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (!(t & hr)) {
        butterfly<kInverse>(v[t], v[t + hr], w[t & (hr - 1)], p, np);
      }
    }
  }
}

// One stage of distance h < 32 in layout A, where the pairs span lanes
// lane and lane ^ h: the two lanes trade half their registers so that each
// holds whole pairs (the low lane those of the even registers, the high lane
// those of the odd ones), run the butterflies with their one twiddle, and
// trade back.
template <bool kInverse, int T>
__device__ __forceinline__ void shfl_stage(uint32_t (&v)[T], int h,
                                           const uint32_t* __restrict__ tw,
                                           int lane, uint32_t p,
                                           uint32_t np) {
  constexpr int n = 32 * T;
  const uint32_t w = __ldg(tw + n - 2 * h + (lane & (h - 1)));
  const bool hi = lane & h;
#pragma unroll
  for (int t = 0; t < T; t += 2) {
    uint32_t r = __shfl_xor_sync(0xffffffffu, hi ? v[t] : v[t + 1], h);
    uint32_t a = hi ? r : v[t];
    uint32_t b = hi ? v[t + 1] : r;
    butterfly<kInverse>(a, b, w, p, np);
    r = __shfl_xor_sync(0xffffffffu, hi ? a : b, h);
    v[t] = hi ? r : a;
    v[t + 1] = hi ? b : r;
  }
}

// The forward transform (ntt.forward_stacked's DIF) of v, layout A in
// natural order, written bit-reversed to `slot` (wpad words), which is also
// the transpose's buffer: the stages of distance >= 32 in registers, those
// of 16 .. T across lanes, one transpose to layout B, the last log2 T in
// registers.
template <int T>
__device__ __forceinline__ void warp_forward(uint32_t (&v)[T], uint32_t* slot,
                                             const uint32_t* __restrict__ tw,
                                             int lane, uint32_t p,
                                             uint32_t np) {
  reg_stages<false, true, T>(v, tw, lane, p, np);
#pragma unroll
  for (int h = 16; h >= T; h >>= 1) shfl_stage<false, T>(v, h, tw, lane, p, np);
  store_a<T>(slot, v, lane);
  __syncwarp();
  load_b<T>(slot, v, lane);
  reg_stages<false, false, T>(v, tw, lane, p, np);
  __syncwarp();
  store_b<T>(slot, v, lane);
}

// The inverse transform (ntt.inverse_stacked) of the spectrum in v, layout
// A in bit-reversed order, back to layout A in natural order, through the
// warp's scratch `scr`: the forward path's steps in reverse.
template <int T>
__device__ __forceinline__ void warp_inverse(uint32_t (&v)[T], uint32_t* scr,
                                             const uint32_t* __restrict__ tw,
                                             int lane, uint32_t p,
                                             uint32_t np) {
  __syncwarp();
  store_a<T>(scr, v, lane);
  __syncwarp();
  load_b<T>(scr, v, lane);
  reg_stages<true, false, T>(v, tw, lane, p, np);
  __syncwarp();
  store_b<T>(scr, v, lane);
  __syncwarp();
  load_a<T>(scr, v, lane);
#pragma unroll
  for (int h = T; h <= 16; h <<= 1) shfl_stage<true, T>(v, h, tw, lane, p, np);
  reg_stages<true, true, T>(v, tw, lane, p, np);
}

// The difference X^a acc_i - acc_i at the lane's coefficients (layout A),
// rounded to the decomposition's precision: the carry chain's start
// (pallas_cmux.py:158-174).
template <int T>
__device__ __forceinline__ void warp_digits_start(
    uint32_t (&state)[T], const uint32_t* __restrict__ row, uint32_t a,
    int non_rep, int lane) {
  constexpr int n = 32 * T;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int c = lane + 32 * t;
    const uint32_t s = (static_cast<uint32_t>(c) - a) & (2u * n - 1u);
    const uint32_t v = __ldg(row + (s & (n - 1u)));
    uint32_t x = (s >= static_cast<uint32_t>(n) ? 0u - v : v) - __ldg(row + c);
    if (non_rep > 0) {
      const uint32_t msb = (x >> (non_rep - 1)) & 1u;
      x = ((x >> non_rep) + msb) << non_rep;
    }
    state[t] = x >> non_rep;
  }
}

// The next level's signed digits (level l first), mod p and twisted into v.
template <int T>
__device__ __forceinline__ void warp_digits_level(
    uint32_t (&v)[T], uint32_t (&state)[T], int base_log,
    const uint32_t* __restrict__ twist, int lane, uint32_t p, uint32_t np) {
  const uint32_t mask = (1u << base_log) - 1u;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const uint32_t res = state[t] & mask;
    state[t] >>= base_log;
    uint32_t carry = ((res - 1u) | state[t]) & res;
    carry >>= base_log - 1;
    state[t] += carry;
    const int32_t digit = static_cast<int32_t>(res - (carry << base_log));
    const uint32_t res_p = static_cast<uint32_t>(
        digit < 0 ? digit + static_cast<int32_t>(p) : digit);
    v[t] = mont_mul(res_p, __ldg(twist + lane + 32 * t), p, np);
  }
}

// The MAC of one output polynomial and prime at the lane's positions (layout
// A): over the `terms` spectra at spec (wpad words apart) and their GGSW
// words at g (gstride apart), the raw products of two terms at a time
// through one lazy REDC into a 64-bit sum, one REDC at the end (as step 3 of
// the block path), 8 positions at a time.
template <int T>
__device__ __forceinline__ void warp_mac(uint32_t (&v)[T],
                                         const uint32_t* spec,
                                         const uint32_t* __restrict__ g,
                                         int terms, int gstride, int lane,
                                         uint32_t p, uint32_t np) {
  constexpr int stride = 33 * T;
  constexpr int kChunk = 8;
#pragma unroll
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    uint64_t sum[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) sum[t] = 0;
    for (int q = 0; q < terms; q += 2) {
      const bool pair = q + 1 < terms;
      const uint32_t* sq = spec + q * stride;
      const uint32_t* gq = g + q * gstride;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int c = lane + 32 * (t0 + t);
        uint64_t raw = static_cast<uint64_t>(sq[wpad(c)]) * __ldg(gq + c);
        if (pair) {
          raw += static_cast<uint64_t>(sq[stride + wpad(c)]) *
                 __ldg(gq + gstride + c);
        }
        const uint32_t m = static_cast<uint32_t>(raw) * np;
        sum[t] += static_cast<uint32_t>(
            (raw + static_cast<uint64_t>(m) * p) >> 32);
      }
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) v[t0 + t] = redc64(sum[t], p, np);
  }
}

// K9 on the warp path, for N = 32 T: the same step as ntt_cmux_kernel.
// Block: one batch row, a warp per (prime, x), x = 0 .. k. First the warp
// takes input polynomial i = x: one carry chain, each level's digits twisted
// into its registers and transformed there, the spectrum stored to shared
// memory. After a barrier it takes output polynomial j = x: the MAC over
// every (lev, i) spectrum of its prime into its registers, the inverse
// transform through its scratch polynomial, the untwist, the result left in
// the scratch. After a second barrier prime 1's warp runs Garner with prime
// 0's result and the accumulate, coalesced. The primes go `per_pass` at a
// time: 2, or 1 in two passes (a barrier more) where both primes' spectra
// do not fit. Shared memory: the pass's spectra dig[prime][lev][i]
// (lev*(k+1) + i, the GGSW's own order), then the scratch polynomials
// scr[prime][x], wpad words each. At T = 32 shared memory, not registers,
// bounds the blocks an SM holds, so there (kReuse) a barrier more after
// the MAC frees the spectra's slots for the scratch polynomials (with one
// prime a pass, prime 0's result waits in a slot of its own past them).
// Registers: T words of a polynomial and T of the carry chain's state; 128
// a thread at T = 32, 80 below (a block takes at most kWarpThreads
// threads).
template <int T>
__global__ void __launch_bounds__(T == 32 ? kWarpThreads : 768)
    ntt_cmux_warp_kernel(const uint32_t* __restrict__ acc,
                         const int32_t* __restrict__ a_hat,
                         const uint32_t* __restrict__ ggsw,
                         const uint32_t* __restrict__ tables,
                         const uint32_t* __restrict__ constants,
                         uint32_t* __restrict__ out, int batch, int ks1,
                         int level, int base_log, int per_pass) {
  constexpr int n = 32 * T;
  constexpr int stride = 33 * T;  // wpad words of a polynomial
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pi = warp / ks1;
  const int x = warp - pi * ks1;
  const int b = blockIdx.x;
  const int terms = level * ks1;  // spectra of one prime
  constexpr bool kReuse = T == 32;
  // the inverse transform's buffer, and where the warp leaves its result
  uint32_t* scr =
      smem + (kReuse ? (per_pass == kPrimes ? warp : x)
                     : per_pass * terms + warp) * stride;
  uint32_t* res = kReuse && per_pass != kPrimes
                      ? smem + (terms + pi * ks1 + x) * stride
                      : scr;
  const uint32_t p = __ldg(constants + kP0 + pi);
  const uint32_t np = __ldg(constants + kNp0 + pi);
  const size_t row = (static_cast<size_t>(x) * batch + b) * n;
  for (int pi0 = 0; pi0 < kPrimes; pi0 += per_pass) {
    const int pl = pi - pi0;  // the prime's place in the pass
    const bool mine = pl >= 0 && pl < per_pass;  // the same in the warp
    if (pi0) __syncthreads();  // the pass before is done with its slots
    uint32_t* dig = smem + (mine ? pl : 0) * terms * stride;
    // 1. the digits of input polynomial x and their forward transforms
    if (mine) {
      const uint32_t* twist = tables + (kTwist * kPrimes + pi) * n;
      const uint32_t* tw = tables + (kWFwd * kPrimes + pi) * n;
      const uint32_t a = static_cast<uint32_t>(a_hat[b]);
      const int non_rep = 32 - base_log * level;
      uint32_t state[T], v[T];
      warp_digits_start<T>(state, acc + row, a, non_rep, lane);
      for (int lev = level - 1; lev >= 0; --lev) {
        uint32_t* slot = dig + (lev * ks1 + x) * stride;
        warp_digits_level<T>(v, state, base_log, twist, lane, p, np);
        warp_forward<T>(v, slot, tw, lane, p, np);
      }
    }
    __syncthreads();
    // 2. output polynomial x: MAC, inverse transform, untwist
    uint32_t v[T];
    if (mine) {
      const uint32_t* g =
          ggsw + static_cast<size_t>(pi) * terms * ks1 * n + x * n;
      warp_mac<T>(v, dig, g, terms, ks1 * n, lane, p, np);
    }
    if (kReuse) __syncthreads();  // every MAC has read the spectra
    if (mine) {
      const uint32_t* tw = tables + (kWInv * kPrimes + pi) * n;
      const uint32_t* untwist = tables + (kUntwist * kPrimes + pi) * n;
      warp_inverse<T>(v, scr, tw, lane, p, np);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        v[t] = mont_mul(v[t], __ldg(untwist + lane + 32 * t), p, np);
      }
      __syncwarp();
      store_a<T>(res, v, lane);
    }
  }
  __syncthreads();
  // 3. Garner (pallas_cmux.py:199-211) and the accumulate, in prime 1's
  // warp, prime 0's result read from where its partner left it
  if (pi == 1) {
    const uint32_t p0 = __ldg(constants + kP0);
    const uint32_t garner = __ldg(constants + kGarner);
    const uint32_t t1 = __ldg(constants + kHalf1);
    const uint32_t t2 = __ldg(constants + kHalf2);
    const uint32_t m_mod_q = __ldg(constants + kMModQ);
    const uint32_t* x1s = res - ks1 * stride;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int c = lane + 32 * t;
      const uint32_t x1 = x1s[wpad(c)];
      const uint32_t r2 = res[wpad(c)];
      const uint32_t x1m = x1 >= p ? x1 - p : x1;
      const uint32_t x2 = mont_mul(sub_mod(r2, x1m, p), garner, p, np);
      uint32_t o = x1 + p0 * x2;
      const bool ge = (x2 > t2) || (x2 == t2 && x1 >= t1);
      o -= ge ? m_mod_q : 0u;
      out[row + c] = __ldg(acc + row + c) + o;
    }
  }
}

template <int T>
int launch_warp(const void* acc, const void* a_hat, const void* ggsw,
                const void* tables, const void* constants, void* out,
                int batch, int ks1, int level, int base_log, int per_pass,
                cudaStream_t stream) {
  // the pass's spectra and the scratch polynomials (at T = 32 in the
  // spectra's slots, and with one prime a pass the two results past them)
  const int polys = T == 32 ? (per_pass == kPrimes ? 2 * level : level + 2)
                            : per_pass * level + kPrimes;
  const size_t smem =
      static_cast<size_t>(polys) * ks1 * 33 * T * sizeof(uint32_t);
  static bool raised = false;  // the 227 KB opt-in, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_cmux_warp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  ntt_cmux_warp_kernel<T><<<batch, kPrimes * ks1 * 32, smem, stream>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(a_hat),
      static_cast<const uint32_t*>(ggsw),
      static_cast<const uint32_t*>(tables),
      static_cast<const uint32_t*>(constants), static_cast<uint32_t*>(out),
      batch, ks1, level, base_log, per_pass);
  return static_cast<int>(cudaGetLastError());
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

// The warp path at N = 256, 512, 1024: one batch row a block, 2 * ks1
// warps (at most kWarpThreads threads); per_pass (primes a pass, 2 or 1)
// comes from bootstrap_ntt.warp_geometry.
int ctt_ntt_cmux_warp(const void* acc, const void* a_hat, const void* ggsw,
                      const void* tables, const void* constants, void* out,
                      int batch, int ks1, int n, int level, int base_log,
                      int per_pass, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ks1 < 1 || kPrimes * ks1 * 32 > kWarpThreads ||
      (per_pass != 1 && per_pass != 2) || level < 1 ||
      level * base_log > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n) {
    case 256:
      return launch_warp<8>(acc, a_hat, ggsw, tables, constants, out, batch,
                            ks1, level, base_log, per_pass, s);
    case 512:
      return launch_warp<16>(acc, a_hat, ggsw, tables, constants, out, batch,
                             ks1, level, base_log, per_pass, s);
    case 1024:
      return launch_warp<32>(acc, a_hat, ggsw, tables, constants, out, batch,
                             ks1, level, base_log, per_pass, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
