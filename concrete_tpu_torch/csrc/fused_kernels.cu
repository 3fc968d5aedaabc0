// Hand-written Hopper (sm_90a) kernel of the fused toeplitz CMux
// accumulation: K8 fused_cmux. It replaces the Pallas kernel of
// concrete_tpu/ops/fused_cmux.py:make_fused_cmux and computes the same bits;
// the plain PyTorch version beside the wrapper
// (concrete_tpu_torch/core/bootstrap_mxu.py:fused_external_product_acc_plain)
// defines what it returns.
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

constexpr int kTile = 64;         // rows, columns and depth of a block tile
constexpr int kWords = kTile / 4;  // packed int8x4 words along the depth
constexpr int kPad = kWords + 1;   // shared row stride: 17 spreads the banks
constexpr int kThreads = 256;      // 16 x 16, each a 4 x 4 patch of outputs

// K8 fused_cmux. Replaces concrete_tpu/ops/fused_cmux.py:make_fused_cmux.
// acc [k+1, B, N] u32, d8 [B, R*N] i8, rings [R, k+1, 2N] u32 -> out
// [k+1, B, N] = acc + sum_li S_li << 8(limb_drop + li), where
// S_li[b, kj, c] = sum_r d8[b, r] * int8(byte (limb_drop + li) of
// ring[r / N, kj][(c - r % N) mod 2N]) is K1's toeplitz product, exact in
// int32 (the plan keeps R*N*64*128 < 2^31).
// Block (column tile, row tile, kj) owns a 64 x 64 output patch for all L
// limbs. Per 64-deep step it loads the d8 tile and the 127 ring words that
// the patch's toeplitz window reads (T[r, c] depends on c - r only), builds
// the L int8 table tiles from that window in shared memory (byte g of four
// window words packed with __byte_perm), and multiplies them with __dp4a.
// No table reaches device memory: the TPU kernel kept it in VMEM for the
// same reason. out may alias acc (each word is read and written by one
// thread).
// Bound on the card: the int8 MACs, 26.8 G a step at TPU128 B=2048, which
// the tensor cores would take in 27 us; __dp4a runs on the integer pipes at
// a small share of that rate. Moving the product onto the tensor cores
// (mma / wgmma) is the next step for this kernel.
template <int L>
__global__ void __launch_bounds__(kThreads)
    fused_cmux_kernel(const uint32_t* acc, const int32_t* __restrict__ d8,
                      const uint32_t* __restrict__ rings, uint32_t* out,
                      int batch, int ks1, int n, int log2n, int k_total,
                      int limb_drop) {
  __shared__ int32_t a_s[kTile][kPad];
  __shared__ int32_t b_s[L][kTile][kPad];
  __shared__ uint32_t win[2 * kTile];
  const int c0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kTile;
  const int kj = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t d8_words = static_cast<size_t>(k_total) / 4;
  const uint32_t wrap = static_cast<uint32_t>(2 * n - 1);

  int32_t sum[L][4][4];
#pragma unroll
  for (int li = 0; li < L; ++li)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[li][i][j] = 0;

  for (int k0 = 0; k0 < k_total; k0 += kTile) {
    const int blk = k0 >> log2n;
    const int r0 = k0 & (n - 1);
    for (int w = threadIdx.x; w < kTile * kWords; w += kThreads) {
      const int row = w >> 4;
      const int k4 = w & 15;
      a_s[row][k4] = b0 + row < batch
                         ? d8[(b0 + row) * d8_words + (k0 >> 2) + k4]
                         : 0;
    }
    if (threadIdx.x < 2 * kTile - 1) {
      const uint32_t* ring =
          rings + (static_cast<size_t>(blk) * ks1 + kj) * 2 * n;
      // win[t] = ring[(c0 - r0 - 63 + t) mod 2N]: T[r0 + k, c0 + c] is
      // win[63 + c - k]
      win[threadIdx.x] = __ldg(
          ring + ((static_cast<uint32_t>(c0 - r0 - (kTile - 1)) +
                   threadIdx.x) & wrap));
    }
    __syncthreads();
    for (int w = threadIdx.x; w < kTile * kWords; w += kThreads) {
      const int c = w >> 4;
      const int k4 = w & 15;
      const int t0 = kTile - 1 + c - 4 * k4;  // window word of k = 4*k4
      const uint32_t w0 = win[t0], w1 = win[t0 - 1];
      const uint32_t w2 = win[t0 - 2], w3 = win[t0 - 3];
#pragma unroll
      for (int li = 0; li < L; ++li) {
        const int g = limb_drop + li;
        const uint32_t sel = static_cast<uint32_t>(g | ((g + 4) << 4));
        const uint32_t lo = __byte_perm(w0, w1, sel);
        const uint32_t hi = __byte_perm(w2, w3, sel);
        b_s[li][c][k4] = static_cast<int32_t>(__byte_perm(lo, hi, 0x5410));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k4 = 0; k4 < kWords; ++k4) {
      int32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][k4];
#pragma unroll
      for (int li = 0; li < L; ++li) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int32_t bv = b_s[li][tx + 16 * j][k4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sum[li][i][j] = __dp4a(a[i], bv, sum[li][i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = b0 + ty + 16 * i;
    if (row >= batch) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t s = 0;
#pragma unroll
      for (int li = 0; li < L; ++li) {
        s += static_cast<uint32_t>(sum[li][i][j]) << (8 * (limb_drop + li));
      }
      const size_t off =
          (static_cast<size_t>(kj) * batch + row) * n + c0 + tx + 16 * j;
      out[off] = acc[off] + s;
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
  const dim3 grid(n / kTile, (batch + kTile - 1) / kTile, ks1);
  fused_cmux_kernel<L><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(acc), static_cast<const int32_t*>(d8),
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
  if (n % kTile != 0 || limb_drop + n_kept != 4) {
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
