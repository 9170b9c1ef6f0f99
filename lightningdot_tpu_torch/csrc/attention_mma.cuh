// The bfloat16 attention on the tensor cores: the forward (attention_mma.cu),
// called by the bf16 branches of ldot_attention (attention.cu) and
// ldot_attention_train_fwd (attention_fused.cu), and the training
// attention's backward (attention_mma_bwd.cu), called by the bf16 branch of
// ldot_attention_train_bwd (attention_fused.cu). float32 stays on those
// files' FMA kernels: the tensor cores have no float32 product.
#pragma once

#include "common.cuh"

namespace ldot {

struct AttnMma {
  const __nv_bfloat16* q;   // [B, S, H, D] (= [B, S, H*D]), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;        // [B, S] additive key bias
  __nv_bfloat16* out;       // [B, S, H, D]
  int seq, heads, head_dim;
  float scale;
  // the normalized epilogue's dropout (rate > 0): keep iff the element's
  // Philox word < thresh (philox.cuh), kept p * mscale rounded to bf16
  const long long* seed;    // one int64 on the device; read iff dropout
  float mscale;             // 1 / (1 - rate) rounded to bf16
  unsigned thresh;
  int dropout;
};

// out = softmax(q k^T * scale + bias) v for every (batch item, head).
// normalize = 0: the deferred epilogue (e = exp(s - max) rounded to bf16,
// the division by the float32 row sum after e . v); 1: p = e / sum rounded
// to bf16 (then dropped, if dropout) before p . v. Needs seq <= 256,
// head_dim <= 64 and a multiple of 8, and 16-byte aligned q, k, v, out;
// returns cudaErrorInvalidValue otherwise.
cudaError_t attention_mma(const AttnMma& a, int batch, int normalize,
                          cudaStream_t stream);

struct AttnMmaBwd {
  const __nv_bfloat16* q;   // [B, S, H, D] (= [B, S, H*D]), contiguous
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;   // the output's cotangent
  const float* bias;        // [B, S] additive key bias
  const long long* seed;    // one int64 on the device; read iff dropout
  __nv_bfloat16* dq;        // [B, S, H, D] each
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;             // [3, B*H, S]: each row's max, sum, delta
  int seq, heads, head_dim;
  float scale;
  float mscale;             // 1 / (1 - rate) rounded to bf16
  float mscale_f32;         // 1 / (1 - rate) rounded to float32
  unsigned thresh;          // keep iff the Philox word < thresh
  int dropout;
};

// dq, dk, dv of the training attention (a dq kernel that also writes the
// statistics, then a dk/dv kernel). Needs seq <= 256, head_dim <= 64 and a
// multiple of 8, and 16-byte aligned q, k, v, g, dq, dk, dv; returns
// cudaErrorInvalidValue otherwise.
cudaError_t attention_mma_bwd(const AttnMmaBwd& a, int batch,
                              cudaStream_t stream);

}  // namespace ldot
