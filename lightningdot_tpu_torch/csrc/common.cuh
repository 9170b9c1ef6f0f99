// Shared helpers for the port's CUDA kernels (built for sm_90a).
//
// Every kernel takes float32 or bfloat16 activations. Arithmetic runs in
// float32; `round_to<T>` rounds a float through T and back, which lets a
// kernel reproduce the points where the reference rounds to the compute
// dtype (identity for float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ldot {

// dtype codes passed over the C interface (ops/_build.py: DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 2^-0.5 rounded to T, as JAX's weak typing rounds the Python constant of
// `x * 2 ** -0.5` to the array's dtype (ops/activations.py::weak_const)
template <typename T>
__device__ __forceinline__ float sqrt_half() {
  return round_to<T>(0.7071067811865476f);
}

// GELU with the plain version's rounding (ops/activations.py::gelu on a
// tensor of dtype T): x * 0.5 * (1 + erf(x / sqrt 2)), each op rounded to T
// (no-op for float), the constant 2^-0.5 too. Exact erff, as torch.erf.
template <typename T>
__device__ __forceinline__ float gelu_rounded(float x) {
  const float half = round_to<T>(x * 0.5f);
  const float arg = round_to<T>(x * sqrt_half<T>());
  const float e = round_to<T>(erff(arg));
  const float one_plus = round_to<T>(1.0f + e);
  return round_to<T>(half * one_plus);
}

// d/dx GELU with the plain version's rounding (ops/ffn_dh1.py::_gelu_grad on
// a tensor of dtype T, the counterpart of lightningdot_tpu/ops/ffn.py::
// _gelu_grad): cdf + x * pdf with cdf = 0.5 * (1 + erf(x / sqrt 2)) and
// pdf = (2 pi)^-0.5 (rounded to T) * exp(-0.5 * x^2), each op and 2^-0.5
// rounded to T;
// __fmul_rn/__fadd_rn keep the compiler from contracting a product and a
// sum into one FMA, which the plain version never does.
template <typename T>
__device__ __forceinline__ float gelu_grad_rounded(float x) {
  const float arg = round_to<T>(__fmul_rn(x, sqrt_half<T>()));
  const float e = round_to<T>(erff(arg));
  const float one_plus = round_to<T>(__fadd_rn(1.0f, e));
  const float cdf = round_to<T>(__fmul_rn(0.5f, one_plus));
  const float sq = round_to<T>(__fmul_rn(x, x));
  const float t = round_to<T>(__fmul_rn(-0.5f, sq));
  const float ex = round_to<T>(expf(t));
  const float pdf =
      round_to<T>(__fmul_rn(round_to<T>(0.3989422804014327f), ex));
  return round_to<T>(__fadd_rn(cdf, round_to<T>(__fmul_rn(x, pdf))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace ldot
