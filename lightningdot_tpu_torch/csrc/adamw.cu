// AdamW with global-norm clipping over every parameter in one launch
// (a multi-tensor apply), updating p, m and v in place.
//
// Replaces the TPU kernel lightningdot_tpu/ops/experimental/adamw_pallas.py::
// _adamw_kernel (launched by adamw_leaf_pallas). The formula is the
// reference's (uniter_model/optim/adamw.py:75-103, training/optim.py::
// FusedAdamW.apply's leaf):
//   g  = g * clip_scale
//   m' = b1 m + (1 - b1) g ;  v' = b2 v + (1 - b2) g^2
//   p' = p - step_size * m' / (sqrt(v') + eps)    eps on the UNCORRECTED v
//   p' = p' - (lr wd) p'                           decay on the post-step p
// with step_size = lr sqrt(1 - b2^t) / (1 - b1^t) computed on the host.
// Each tensor carries a learning-rate factor f beside its decay wd (the
// VQA head's --vqa_lr_mul, JAX's optax.multi_transform over {body, head}):
// its step size is step_size * f and its decay (lr * f) * wd. At f = 1
// both products are exact, so the update is the one without a factor.
// Every operation is __fmul_rn/__fadd_rn/__fdiv_rn/__fsqrt_rn in the order
// of the plain version (ops/adamw.py::_adamw_math), so that the compiler
// contracts nothing into an FMA and the two agree bit for bit.
//
// Design. The TPU kernel takes one leaf per call, and only float32 leaves
// of at least 16,384 elements whose size is a multiple of 128. Here one
// launch walks a device table of every tensor (p, g, m, v, numel, wd): the
// host cuts each tensor into chunks of kChunk elements, and block b updates
// chunk b of its tensor, so sizes need no alignment and the ~400 tensors of
// two BERT-base towers cost one launch. g may be null (a parameter outside
// the graph: its gradient counts as zero, as in JAX); m is float32 or
// bfloat16 (the update runs in float32 either way). The clip scale is read
// from device memory, so a step needs no host synchronization.
//
// Bound: pure streaming, 28 bytes per parameter (24 with a bf16 m): device
// memory bandwidth bounds it; the loop is a grid-stride over a chunk with
// neighbouring threads on neighbouring elements.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 1 << 15;

// one row of the table (ops/adamw.py builds it: int64 [n, 6])
struct Entry {
  long long p, g, m, v, numel;
  float wd;
  float lr_mul;
};

template <bool kMBf16>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Entry* __restrict__ table,
                 const int2* __restrict__ chunks,
                 const float* __restrict__ clip_scale, float step_size,
                 float lr, float b1, float omb1, float b2, float omb2,
                 float eps) {
  const int2 c = chunks[blockIdx.x];
  const Entry e = table[c.x];
  float* p = reinterpret_cast<float*>(e.p);
  const float* g = reinterpret_cast<const float*>(e.g);
  float* v = reinterpret_cast<float*>(e.v);
  const long long begin = static_cast<long long>(c.y) * kChunk;
  const long long end = min(begin + kChunk, e.numel);
  const float scale = *clip_scale;
  const float step = __fmul_rn(step_size, e.lr_mul);
  const float lr_wd = __fmul_rn(__fmul_rn(lr, e.lr_mul), e.wd);
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float gi = g != nullptr ? __fmul_rn(g[i], scale) : 0.f;
    float mi;
    if constexpr (kMBf16)
      mi = __bfloat162float(reinterpret_cast<__nv_bfloat16*>(e.m)[i]);
    else
      mi = reinterpret_cast<float*>(e.m)[i];
    const float m2 = __fadd_rn(__fmul_rn(b1, mi), __fmul_rn(omb1, gi));
    const float v2 =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(omb2, __fmul_rn(gi, gi)));
    const float denom = __fadd_rn(__fsqrt_rn(v2), eps);
    float p2 = __fsub_rn(p[i], __fdiv_rn(__fmul_rn(step, m2), denom));
    if (e.wd != 0.f) p2 = __fsub_rn(p2, __fmul_rn(lr_wd, p2));
    p[i] = p2;
    v[i] = v2;
    if constexpr (kMBf16)
      reinterpret_cast<__nv_bfloat16*>(e.m)[i] = __float2bfloat16_rn(m2);
    else
      reinterpret_cast<float*>(e.m)[i] = m2;
  }
}

}  // namespace

// table: device array of Entry (int64 [n_tensors, 6]: pointers, numel, then
// wd and lr_mul as two float32 in the last int64); chunks: device int32
// [n_chunks, 2] of (tensor index, chunk index); clip_scale: one device
// float32. p, g, v float32; m float32 or, with m_bf16, bfloat16; each
// tensor contiguous. Chunks hold 32,768 elements.
extern "C" int ldot_adamw(const void* table, const void* chunks,
                          int n_chunks, const float* clip_scale,
                          float step_size, float lr, float b1, float omb1,
                          float b2, float omb2, float eps, int m_bf16,
                          void* stream) {
  static_assert(sizeof(Entry) == 48, "Entry must match ops/adamw.py");
  if (n_chunks <= 0 || table == nullptr || chunks == nullptr ||
      clip_scale == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Entry* t = static_cast<const Entry*>(table);
  const int2* c = static_cast<const int2*>(chunks);
  if (m_bf16)
    adamw_kernel<true><<<n_chunks, kThreads, 0, s>>>(
        t, c, clip_scale, step_size, lr, b1, omb1, b2, omb2, eps);
  else
    adamw_kernel<false><<<n_chunks, kThreads, 0, s>>>(
        t, c, clip_scale, step_size, lr, b1, omb1, b2, omb2, eps);
  return cudaGetLastError();
}
