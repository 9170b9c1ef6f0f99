// The bfloat16 attention forward on the tensor cores (attention_mma.cu),
// called by the bf16 branches of ldot_attention (attention.cu) and
// ldot_attention_train_fwd (attention_fused.cu). float32 stays on those
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

}  // namespace ldot
