// FFN backward through the GELU:
//   dh1 = round(g W2^T) * gelu'(h1),  g [rows, H], h1 [rows, I], W2 [I, H].
//
// Replaces the TPU kernel lightningdot_tpu/ops/experimental/ffn_dh1.py::
// _dh1_kernel (launched by dh1_pallas). Numerics follow the default branch
// of ops/ffn.py::_ffn_bwd (:236-237), which is also this kernel's plain
// version (ops/ffn_dh1.py::_dh1_math): dinter = g W2^T accumulated in
// float32 and rounded to the compute dtype, gelu'(h1) evaluated op by op
// with the compute dtype's rounding after each op (common.cuh::
// gelu_grad_rounded, exact erff and expf), one more rounding after the
// product. The TPU kernel's A&S erf polynomial existed only because Mosaic
// had no erf and is not carried over.
//
// W2 is read in the JAX [in, out] layout: row i of W2 holds the H weights
// that dinter[:, i] contracts with, so both operands of the product run
// along their contiguous axis (an "NT" product).
//
// Bound: at the training shapes (2,048-4,096 rows, H 768, I 3072) the
// product is 9.7-19.3 GFLOP against ~40-60 MB of traffic, far above the
// card's ridge: operations bound it. As on the TPU, dinter [rows, I] never
// reaches device memory: the epilogue applies gelu'(h1) to the accumulator
// and writes dh1 once. This first version multiplies on the FP32 FMA units
// (no tensor cores): each 256-thread block computes a 128 x 128 tile of
// dh1, 8 x 8 values a thread, over 32-deep slices of H staged in shared
// memory as float32. Simple and right first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows and columns of dh1 per block
constexpr int kDepth = 32;   // slice of H per shared-memory stage
constexpr int kPer = 8;      // rows (and columns) per thread
constexpr int kPad = kTile + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dh1_kernel(const T* __restrict__ g, const T* __restrict__ h1,
               const T* __restrict__ w2, T* __restrict__ dh1, int rows,
               int H, int I) {
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
      gs[k][m] = r < rows
                     ? ldot::to_f32(g[static_cast<size_t>(r) * H + k0 + k])
                     : 0.f;
      ws[k][m] = c < I
                     ? ldot::to_f32(w2[static_cast<size_t>(c) * H + k0 + k])
                     : 0.f;
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
      const float dinter = ldot::round_to<T>(acc[i][j]);
      const float gp = ldot::gelu_grad_rounded<T>(ldot::to_f32(h1[at]));
      dh1[at] = ldot::from_f32<T>(__fmul_rn(dinter, gp));
    }
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* h1, const void* w2, void* dh1,
                   int rows, int H, int I, cudaStream_t stream) {
  const dim3 grid((I + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  dh1_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(h1),
      static_cast<const T*>(w2), static_cast<T*>(dh1), rows, H, I);
  return cudaGetLastError();
}

}  // namespace

// g: [rows, H]; h1, dh1: [rows, I]; w2: [I, H]; all contiguous, one dtype
// (float32 or bfloat16 by dtype code). H % 32 == 0; rows and I any size.
extern "C" int ldot_ffn_dh1(const void* g, const void* h1, const void* w2,
                            void* dh1, int rows, int H, int I, int dtype,
                            void* stream) {
  if (rows <= 0 || H <= 0 || H % kDepth != 0 || I <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return launch<float>(g, h1, w2, dh1, rows, H, I, s);
  if (dtype == ldot::kBFloat16)
    return launch<__nv_bfloat16>(g, h1, w2, dh1, rows, H, I, s);
  return cudaErrorInvalidValue;
}
