// Hand-written Hopper (sm_90a) kernel of the fused toeplitz CMux
// accumulation: K8 fused_cmux. It replaces the Pallas kernel of
// concrete_tpu/ops/fused_cmux.py:make_fused_cmux and computes the same bits;
// the plain PyTorch version beside the wrapper
// (concrete_tpu_torch/core/bootstrap_mxu.py:fused_external_product_acc_plain)
// defines what it returns.
//
// What bounds it: the int8 MACs, B * R*N * (k+1)*L*N of them a step (26.8 G
// at TPU128 B=2048), which the tensor cores' 1,979 TOP/s would take in
// 27 us. The first kernel ran them on __dp4a, whose ceiling on the integer
// pipes is ~67 T MAC/s; this one runs them on the int8 tensor cores:
//  1. mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, fragments loaded with
//     ldmatrix.x4 from shared memory; int32 accumulators, exact (the plan
//     keeps R*N*64*128 < 2^31), no .satfinite.
//  2. The window trick: the toeplitz table T[r, c] = limbs of ring[(c - r)
//     mod 2N] depends on c - r only, so a 64-column x 64-deep patch needs a
//     127-word window of the ring per step; the L int8 limb tiles are built
//     from it in shared memory with __byte_perm, K-contiguous per column
//     (the "col" B operand that ldmatrix reads). No table reaches device
//     memory.
//  3. Tiles for the tensor cores: a block owns 128 batch rows x 64 columns
//     x all L limbs of one output polynomial; 8 warps of 32 x 32 each, the
//     L limbs are L more output tiles sharing one A fragment; 32*L int32
//     accumulators a thread (128 at L = 4).
//  4. Asynchronous copies and one barrier a step: the d8 tile of step k+1
//     and the ring window of step k+2 are copied with cp.async, and the
//     limb tiles of step k+1 built, while the warps run step k's MMAs
//     (two d8 and limb-tile buffers, three windows).
//  5. Epilogue in registers: sum_li S_li << 8(limb_drop + li) + acc.
// out may alias acc: each word is read and written by one thread.
//
// Built by concrete_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_kernels.so fused_kernels.cu
// The extern "C" entry point launches the kernel on the given stream and
// returns the CUDA error code.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;          // batch rows of a block tile
constexpr int kBN = 64;           // output columns of a block tile
constexpr int kBK = 64;           // depth (int8) of one pipeline step
constexpr int kKWords = kBK / 4;  // packed int8x4 words along the depth
// shared row stride in words: 20 words (80 bytes) keeps the 8 rows an
// ldmatrix phase reads on distinct banks
constexpr int kStride = kKWords + 4;
constexpr int kWin = kBN + kBK - 1;  // ring words a step's patch reads
// warps: 4 along the rows (32 each) x kWarpsN along the columns; a warp
// owns 2 m16 x kNT n8 MMA tiles per limb
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * 4 * kWarpsN;
constexpr int kNT = kBN / kWarpsN / 8;

// shared words of a block: two d8 tiles, two sets of L limb tiles, three
// ring windows (61.5 KB at L = 4)
template <int L>
constexpr int SmemWords() {
  return 2 * (kBM + L * kBN) * kStride + 3 * (kWin + 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 b16 matrices (8 rows of 16 bytes each): lane l gives the row
// address of matrix l/8, row l%8; r[i] gets bytes 4*(lane%4).. of row
// lane/4 of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4],
                                            const void* row_addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row_addr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// K8 fused_cmux. Replaces concrete_tpu/ops/fused_cmux.py:make_fused_cmux.
// acc [k+1, B, N] u32, d8 [B, R*N] i8, rings [R, k+1, 2N] u32 -> out
// [k+1, B, N] = acc + sum_li S_li << 8(limb_drop + li), where
// S_li[b, kj, c] = sum_r d8[b, r] * int8(byte (limb_drop + li) of
// ring[r / N, kj][(c - r % N) mod 2N]) is K1's toeplitz product.
// Block (column tile, row tile, kj); warp w owns rows 32*(w%4).. and
// columns 8*kNT*(w/4).. of the tile: 2 m16 x kNT n8 MMA tiles per limb.
template <int L>
__global__ void __launch_bounds__(kThreads)
    fused_cmux_kernel(const uint32_t* acc, const int8_t* __restrict__ d8,
                      const uint32_t* __restrict__ rings, uint32_t* out,
                      int batch, int ks1, int n, int log2n, int k_total,
                      int limb_drop) {
  // dynamic shared memory: the d8 tiles of two steps, the limb tiles of
  // two steps and the ring windows of three (SmemWords<L>)
  extern __shared__ __align__(16) uint32_t smem[];
  auto a_s = reinterpret_cast<uint32_t(*)[kBM][kStride]>(smem);
  auto b_s = reinterpret_cast<uint32_t(*)[L][kBN][kStride]>(
      smem + 2 * kBM * kStride);
  auto win = reinterpret_cast<uint32_t(*)[kWin + 1]>(
      smem + 2 * (kBM + L * kBN) * kStride);
  const int c0 = blockIdx.x * kBN;
  const int b0 = blockIdx.y * kBM;
  const int kj = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * (8 * kNT);
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);
  const int steps = k_total / kBK;

  // the d8 tile of step s (128 rows x 64 bytes, rows past the batch
  // zero-filled) into a_s[s & 1]
  auto fetch_a = [&](int s) {
    const int k0 = s * kBK;
#pragma unroll
    for (int h = 0; h < kBM * kBK / 16 / kThreads; ++h) {
      const int chunk = threadIdx.x + h * kThreads;
      const int row = chunk / (kBK / 16);
      const int part = chunk % (kBK / 16);
      const bool valid = b0 + row < batch;
      const int8_t* src =
          d8 + (valid ? static_cast<size_t>(b0 + row) * k_total + k0 + 16 * part
                      : 0);
      cp_async16(&a_s[s & 1][row][4 * part], src, valid ? 16 : 0);
    }
  };
  // the ring window of step s into win[s % 3]: win[t] = ring[(c0 - r0 -
  // (kBK - 1) + t) mod 2N], so T[r0 + k, c0 + c] is win[kBK - 1 + c - k]
  auto fetch_window = [&](int s) {
    const int k0 = s * kBK;
    const uint32_t* ring =
        rings + (static_cast<size_t>(k0 >> log2n) * ks1 + kj) * 2 * n;
    const uint32_t start = static_cast<uint32_t>(c0 - (k0 & (n - 1)) - (kBK - 1));
    for (int t = threadIdx.x; t < kWin; t += kThreads) {
      cp_async4(&win[s % 3][t], ring + ((start + t) & wrap));
    }
  };
  // the L limb tiles of step s into b_s[s & 1]: column c, depth word k4
  // holds byte g of window words kBK - 1 + c - 4*k4 - {0, 1, 2, 3}
  auto build = [&](int s) {
    const uint32_t* w = win[s % 3];
    for (int i = threadIdx.x; i < kBN * kKWords; i += kThreads) {
      const int c = i / kKWords;
      const int k4 = i % kKWords;
      const int t0 = kBK - 1 + c - 4 * k4;
      const uint32_t w0 = w[t0], w1 = w[t0 - 1];
      const uint32_t w2 = w[t0 - 2], w3 = w[t0 - 3];
#pragma unroll
      for (int li = 0; li < L; ++li) {
        const int g = limb_drop + li;
        const uint32_t sel = static_cast<uint32_t>(g | ((g + 4) << 4));
        const uint32_t lo = __byte_perm(w0, w1, sel);
        const uint32_t hi = __byte_perm(w2, w3, sel);
        b_s[s & 1][li][c][k4] = __byte_perm(lo, hi, 0x5410);
      }
    }
  };

  int32_t sum[L][2][kNT][4];
#pragma unroll
  for (int li = 0; li < L; ++li)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[li][mt][nt][i] = 0;

  // one barrier a step: step s's MMAs run beside step s+1's table build
  // and the copies of step s+1's d8 tile and step s+2's window
  fetch_a(0);
  fetch_window(0);
  if (steps > 1) fetch_window(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  build(0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    // visible now: d8 tile s, window s+1, limb tiles s; every warp is done
    // with step s-1, whose buffers step s+1 (and window s+2) reuse
    __syncthreads();
    if (s + 1 < steps) fetch_a(s + 1);
    if (s + 2 < steps) fetch_window(s + 2);
    cp_async_commit();
    if (s + 1 < steps) build(s + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm + 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(a[mt], &a_s[buf][row][(kk >> 2) + (lane >> 4) * 4]);
      }
#pragma unroll
      for (int li = 0; li < L; ++li) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          const int col = wn + 16 * np + (lane & 7) + (lane >> 4) * 8;
          uint32_t b[4];
          ldmatrix_x4(b,
                      &b_s[buf][li][col][(kk >> 2) + ((lane >> 3) & 1) * 4]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8(sum[li][mt][2 * np], a[mt], b);
            mma_s8(sum[li][mt][2 * np + 1], a[mt], b + 2);
          }
        }
      }
    }
  }

  // accumulator i of tile (mt, nt): row g (+8 for i >= 2), column 2*tig
  // (+1 for odd i)
  const int g = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = b0 + wm + 16 * mt + g + (i >= 2 ? 8 : 0);
      if (row >= batch) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t s = 0;
#pragma unroll
        for (int li = 0; li < L; ++li) {
          s += static_cast<uint32_t>(sum[li][mt][nt][i])
               << (8 * (limb_drop + li));
        }
        const size_t off = (static_cast<size_t>(kj) * batch + row) * n + c0 +
                           wn + 8 * nt + 2 * tig + (i & 1);
        out[off] = acc[off] + s;
      }
    }
  }
}

int log2_int(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <int L>
int launch(const void* acc, const void* d8, const void* rings, void* out,
           int batch, int ks1, int n, int r_blocks, int limb_drop,
           cudaStream_t stream) {
  const int smem = SmemWords<L>() * static_cast<int>(sizeof(uint32_t));
  static bool raised = false;  // above 48 KB, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_cmux_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised = true;
  }
  const dim3 grid(n / kBN, (batch + kBM - 1) / kBM, ks1);
  fused_cmux_kernel<L><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int8_t*>(d8),
      static_cast<const uint32_t*>(rings), static_cast<uint32_t*>(out), batch,
      ks1, n, log2_int(n), r_blocks * n, limb_drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ctt_fused_cmux(const void* acc, const void* d8, const void* rings,
                   void* out, int batch, int ks1, int n, int r_blocks,
                   int n_kept, int limb_drop, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % kBN != 0 || n % kBK != 0 || limb_drop + n_kept != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n_kept) {
    case 4:
      return launch<4>(acc, d8, rings, out, batch, ks1, n, r_blocks,
                       limb_drop, s);
    case 3:
      return launch<3>(acc, d8, rings, out, batch, ks1, n, r_blocks,
                       limb_drop, s);
    case 2:
      return launch<2>(acc, d8, rings, out, batch, ks1, n, r_blocks,
                       limb_drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
