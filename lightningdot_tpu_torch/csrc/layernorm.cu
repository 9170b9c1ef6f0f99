// Row LayerNorm: out = (x - mean) * rsqrt(var + eps) * scale + bias.
//
// Replaces the TPU kernel lightningdot_tpu/ops/layernorm.py::_ln_kernel
// (launched by _ln_pallas). Statistics are float32 whatever the input
// dtype; the output is written in the input dtype.
//
// Bound: device-memory bytes. A row is read once and written once; the
// arithmetic is a few operations per element. The design is one warp per
// row that holds the row in registers (H/32 values per lane), so mean and
// variance are two register passes with warp shuffles and the row is never
// read twice from memory. Eight rows share a block; lanes read neighbouring
// elements, so every load and store is coalesced.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T, int kPerLane>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int rows, int hidden, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= rows) return;
  const int lane = threadIdx.x;
  const T* xr = x + static_cast<size_t>(row) * hidden;

  float v[kPerLane];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < hidden ? ldot::to_f32(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = ldot::warp_sum(sum) / hidden;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < hidden) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(ldot::warp_sum(sq) / hidden + eps);

  T* orow = out + static_cast<size_t>(row) * hidden;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < hidden)
      orow[c] = ldot::from_f32<T>((v[i] - mean) * inv * scale[c] + bias[c]);
  }
}

template <typename T, int kPerLane>
cudaError_t launch(const void* x, const float* scale, const float* bias,
                   void* out, int rows, int hidden, float eps,
                   cudaStream_t stream) {
  const dim3 block(32, kRowsPerBlock);
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layernorm_kernel<T, kPerLane><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows,
      hidden, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, const float* bias,
                     void* out, int rows, int hidden, float eps,
                     cudaStream_t stream) {
  // 768 (the layers) and 1536 (the projection head)
  const int per_lane = (hidden + 31) / 32;
  if (per_lane <= 24)
    return launch<T, 24>(x, scale, bias, out, rows, hidden, eps, stream);
  if (per_lane <= 48)
    return launch<T, 48>(x, scale, bias, out, rows, hidden, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: [rows, hidden] contiguous, float32 or bfloat16 (dtype code);
// scale, bias: [hidden] float32. hidden <= 1536.
extern "C" int ldot_layernorm(const void* x, const float* scale,
                              const float* bias, void* out, int rows,
                              int hidden, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || hidden <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return dispatch<float>(x, scale, bias, out, rows, hidden, eps, s);
  if (dtype == ldot::kBFloat16)
    return dispatch<__nv_bfloat16>(x, scale, bias, out, rows, hidden, eps, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ldot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
