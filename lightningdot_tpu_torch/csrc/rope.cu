// Rotary position embedding in DeepSeek-V3's published layout (the
// Moonlight tower's q_pe and k_pe, models/moonlight.py): the d = 64 dims of
// a head are read as pairs (x[2i], x[2i + 1]) and written de-interleaved,
//
//   out[i]         = x[2i] cos(p w_i) - x[2i + 1] sin(p w_i)
//   out[d / 2 + i] = x[2i + 1] cos(p w_i) + x[2i] sin(p w_i)
//
// with w_i = 1 / theta^(2i / d) and p the row's position (row % S), as
// modeling_deepseek.py's apply_rotary_pos_emb (its view-transpose of q and
// k, then rotate_half). `inverse` applies the transpose (the backward).
//
// Replaces no TPU kernel (BERT has learned positions). Bound: device
// memory, a read and a write of each element; one thread a pair, the
// angle computed in float32 from the row's position (no table).
#include <cstdint>

#include "common.cuh"

namespace {

using ldot::from_f32;
using ldot::to_f32;

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int rows, int heads, int S, int dim, float theta,
                            int inverse) {
  const int half = dim / 2;
  const size_t n = static_cast<size_t>(rows) * heads * half;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx % half);
    const size_t rh = idx / half;
    const int pos = static_cast<int>((rh / heads) % S);
    const float w = 1.0f / powf(theta, static_cast<float>(2 * i) /
                                           static_cast<float>(dim));
    float s, c;
    sincosf(static_cast<float>(pos) * w, &s, &c);
    const size_t base = rh * dim;
    if (!inverse) {
      const float a = to_f32(x[base + 2 * i]);
      const float b = to_f32(x[base + 2 * i + 1]);
      out[base + i] = from_f32<T>(a * c - b * s);
      out[base + half + i] = from_f32<T>(b * c + a * s);
    } else {
      const float a = to_f32(x[base + i]);
      const float b = to_f32(x[base + half + i]);
      out[base + 2 * i] = from_f32<T>(a * c + b * s);
      out[base + 2 * i + 1] = from_f32<T>(b * c - a * s);
    }
  }
}

}  // namespace

// x, out: [rows, heads, dim] contiguous, float32 or bfloat16 (dtype code),
// distinct; rows = B S with positions row % S; dim even.
extern "C" int ldot_rope(const void* x, void* out, int rows, int heads,
                         int S, int dim, float theta, int inverse, int dtype,
                         void* stream) {
  if (rows <= 0 || heads <= 0 || S <= 0 || dim <= 0 || dim % 2)
    return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(rows) * heads * (dim / 2);
  const int blocks = static_cast<int>((n + 255) / 256 < 8192 ? (n + 255) / 256
                                                             : 8192);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    rope_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, heads,
        S, dim, theta, inverse);
  else if (dtype == ldot::kBFloat16)
    rope_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), rows, heads, S, dim, theta,
        inverse);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
