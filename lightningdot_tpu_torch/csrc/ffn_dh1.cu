// FFN backward through the GELU, float32, on FP32 FMA units (every FFN
// layer's backward in training with --compute_dtype f32):
//   dh1 = (g W2^T) * gelu'(h1),  g [rows, H], h1 [rows, I], W2 [I, H].
//
// Replaces, in float32, the TPU kernel lightningdot_tpu/ops/experimental/
// ffn_dh1.py::_dh1_kernel (:28, launched by dh1_pallas). The bfloat16 form,
// the one training runs, is an epilogue of ffn_mma.cu's tensor-core GEMM
// (ldot_ffn_dh1_mma): the tensor cores have no float32 product. Numerics
// follow the default branch of ops/ffn.py::_ffn_bwd (:236-237), which is
// also this kernel's plain version (ops/ffn_dh1.py::_dh1_math): dinter = g
// W2^T accumulated in float32, gelu'(h1) evaluated op by op (common.cuh::
// gelu_grad_rounded, exact erff and expf), then the product. The TPU
// kernel's A&S erf polynomial existed only because Mosaic had no erf and is
// not carried over.
//
// W2 is read in the JAX [in, out] layout: row i of W2 holds the H weights
// that dinter[:, i] contracts with, so both operands of the product run
// along their contiguous axis (an "NT" product).
//
// Bound: at the training shapes (2,048-4,096 rows, H 768, I 3072) the
// product is 9.7-19.3 GFLOP, above the card's ridge: the FP32 FMA rate
// bounds it (144-289 us at 67 TFLOP/s). As on the TPU, dinter [rows, I]
// never reaches device memory: the epilogue applies gelu'(h1) to the
// accumulator and writes dh1 once. Each 256-thread block computes a 128 x
// 128 tile of dh1, 8 x 8 values a thread, over 32-deep slices of H staged
// in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows and columns of dh1 per block
constexpr int kDepth = 32;   // slice of H per shared-memory stage
constexpr int kPer = 8;      // rows (and columns) per thread
constexpr int kPad = kTile + 1;

__global__ void __launch_bounds__(kThreads)
    dh1_kernel(const float* __restrict__ g, const float* __restrict__ h1,
               const float* __restrict__ w2, float* __restrict__ dh1,
               int rows, int H, int I) {
  __shared__ float gs[kDepth][kPad];   // gs[k][m] = g[row0 + m][k0 + k]
  __shared__ float ws[kDepth][kPad];   // ws[k][n] = W2[col0 + n][k0 + k]

  const int tid = threadIdx.x;
  const int tx = tid % 16;     // columns tx + 16 j
  const int ty = tid / 16;     // rows ty + 16 j
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) acc[a][b] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kDepth) {
    // 32 neighbouring threads read 32 neighbouring k of one row
    for (int idx = tid; idx < kTile * kDepth; idx += kThreads) {
      const int m = idx / kDepth;
      const int k = idx % kDepth;
      const int r = row0 + m;
      const int c = col0 + m;
      gs[k][m] = r < rows ? g[static_cast<size_t>(r) * H + k0 + k] : 0.f;
      ws[k][m] = c < I ? w2[static_cast<size_t>(c) * H + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kDepth; ++k) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a[j] = gs[k][ty + 16 * j];
        b[j] = ws[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= I) continue;
      const size_t at = static_cast<size_t>(r) * I + c;
      dh1[at] = __fmul_rn(acc[i][j], ldot::gelu_grad_rounded<float>(h1[at]));
    }
  }
}

}  // namespace

// g: [rows, H]; h1, dh1: [rows, I]; w2: [I, H]; all contiguous float32.
// H % 32 == 0; rows and I any size.
extern "C" int ldot_ffn_dh1(const float* g, const float* h1, const float* w2,
                            float* dh1, int rows, int H, int I,
                            void* stream) {
  if (rows <= 0 || H <= 0 || H % kDepth != 0 || I <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((I + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  dh1_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, h1, w2, dh1, rows, H, I);
  return cudaGetLastError();
}
