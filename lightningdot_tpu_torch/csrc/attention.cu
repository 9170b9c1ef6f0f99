// Self-attention for sequences up to 256 in float32, register-blocked on
// the FMA units, one block per (batch, head, tile of 64 queries): out =
// softmax(q k^T * scale + key_bias) v. The bfloat16 forms go to the
// tensor-core kernel (attention_mma.cu); the C entry below splits by dtype.
// The same kernel with a dropout pass (kDrop) is the training attention's
// float32 forward (ldot_attention_train_fwd, attention_fused.cu), which
// replaces lightningdot_tpu/ops/experimental/attention_fused.py::
// _fwd_kernel (:117): p = e / sum, then p * mscale where the element's
// Philox word (philox.cuh) is below thresh and 0 elsewhere, before p v
// (ops/attention_fused.py::_fused_attn_fwd_math). The building blocks
// (staging, the score and P V microtiles, the warp-order softmax) are in
// attention_fma.cuh, shared with the training attention's backward.
//
// Replaces the TPU kernel lightningdot_tpu/ops/attention.py::_attn_kernel
// (:87, launched by _attention_pallas, :125) in float32, the dtype the
// cross-encoder teacher computes in (KD, re-ranking: every teacher layer,
// [640, 167] a KD step, [128, 96-168] a re-ranking block) and the
// card-vs-CPU checks. It reads q, k and v straight out of the
// projection-native [B,S,H,D] layout by strides and writes the output in
// that layout, so no transpose ever touches device memory.
//
// Bit-equal to its twin (ops/attention.py::_attention_math on the card:
// cuBLAS float32 products with TF32 off, torch.softmax), which the float32
// checks on the card hold it to. Register blocking changes which thread
// computes a sum, never the order of one:
//   - each score is one sequential FMA chain over d = 0 .. D-1, then
//     * scale, then + bias, each rounded (no contraction);
//   - each row's max, exp(s - max) and sum as torch's warp softmax takes
//     them: lane l of 32 sums elements l, l + 32, ... in turn, then the 32
//     partials meet in a butterfly (16, 8, 4, 2, 1). Here 4 threads share
//     a row, each holding the partials of lanes c, c + 4, ..., c + 28: the
//     butterfly's first three levels are additions inside the thread, the
//     last two shuffles among the 4;
//   - each output is one sequential FMA chain over j = 0 .. S-1.
// Two numeric paths mirror ops/attention.py::_attention_math: defer = 0,
// normalized probabilities (p = e / sum) before p v; defer = 1,
// un-normalized e, the float32 row sum kept aside and the division applied
// after e v. The dropout pass (defer 0) takes a row's keys in groups of 4,
// one Philox draw a group, the 4 threads of the row at groups c, c + 4,
// ..., each walking its group from element c on (mod 4), so that the 4
// threads hit 4 distinct banks of P.
//
// Bound: 4 B H S^2 D flops at 67 TFLOP/s (0.82 ms at the KD teacher's
// [640, 167, 12, 64]); q, k, v and out once each at 3.35 TB/s (0.39 ms).
// Design: a block stages the tile's Q [64][D + 4] and K [S][D + 4] as they
// lie, by cp.async, and computes the 64 x S scores in 4 x 4 register
// microtiles: a thread takes queries ql + {0, 4, 8, 12} and keys kl + {0,
// 8, 16, 24} of a 16 x 32 chunk (ql = lane % 4, kl = lane / 4), and per 4
// values of d, four 128-bit loads of Q and four of K feed 64 FMAs. The
// rows' padding puts the 4 query rows and the 8 key rows a warp reads in
// distinct banks. A chunk past the last whole 32 keys takes only the keys
// it has (1-3 a thread). The scores go to P [S][64 + 8] (query-minor, the
// padding chosen so that the softmax's 4 threads a row, 8 rows a warp, hit
// 32 distinct banks). V [S][D] then arrives by cp.async over K's space
// while the softmax runs; the softmax skips the division of a zero
// (0 / sum is +0: masked keys' exp underflows to 0, and the division was a
// fifth of the kernel's time at [640, 167] with half the keys masked). P V
// runs in 8 query x 4 head-dim microtiles: per key, two 128-bit loads of P
// and one of V feed 32 FMAs. K and V are staged once for 64 queries (3
// tiles a head at S = 167). Shared memory: (S + 64)(D + 4) + 72 S floats,
// 111 KB at S = 167, D = 64, so two 8-warp blocks share an SM (16 warps);
// 161 KB at S = 256 (one). The grid is batch * heads * ceil(S / 64) blocks,
// the tiles of a head adjacent, so they find its K and V in L2.
// Development comparisons on an H100 (not kept): K and Q staged transposed
// (k-major) through registers, 8 x 4 score microtiles, 4 x 4 for P V, 8
// threads a softmax row, the row max folded into the score phase and
// unrolled division passes were each no faster at [640, 167].
#include <cstdint>

#include "attention_fma.cuh"
#include "attention_mma.cuh"

namespace {

using namespace ldot::fma;

constexpr int kTile = 64;          // query rows per block
constexpr int kLdP = kTile + 8;    // P [j][query] row stride, floats
constexpr int kPvRowsFwd = 8;      // rows of a P V microtile

// K [S][D4 + 4] (V [S][D4] over it once the scores are done), Q [kTile][D4
// + 4], P [S][kLdP], the row sums [kTile]; every part a multiple of 4 floats
__host__ __device__ constexpr size_t smem_floats(int seq, int head_dim) {
  return static_cast<size_t>(seq + kTile) * operand_ld(head_dim) +
         static_cast<size_t>(seq) * kLdP + kTile;
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    attention_kernel(ldot::AttnFma a, int tiles, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int S = a.seq;
  const int D = a.head_dim;
  const int D4 = round4(D);
  const int ldk = operand_ld(D);
  float* sk = smem;                              // K [S][ldk]
  float* sv = smem;                              // V [S][D4], after scores
  float* sq = smem + static_cast<size_t>(S) * ldk;   // Q [kTile][ldk]
  float* sp = sq + kTile * ldk;                  // P [S][kLdP]
  float* srow = sp + S * kLdP;                   // [kTile]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles;
  const int bh = blockIdx.x / tiles;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int i0 = tile * kTile;                   // first query row
  const int nq = min(kTile, S - i0);             // query rows in the tile
  const size_t rs = static_cast<size_t>(a.heads) * D;   // row stride
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;

  // Q and K as they lie, zero past the tile's rows and past D
  stage(a.q, base, rs, i0, nq, kTile, D, ldk, sq, vec);
  stage(a.k, base, rs, 0, S, S, D, ldk, sk, vec);
  if (vec) {
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  }
  __syncthreads();

  const float* brow = a.bias + static_cast<size_t>(b) * S;
  score_phase<kLdP, kBiasCol>(sq, nq, sk, S, ldk, D4, a.scale, brow, sp);
  __syncthreads();   // P complete; K no longer read

  // V over K's space, in flight during the softmax
  stage(a.v, base, rs, 0, S, S, D, D4, sv, vec);
  if (vec) ldot::cp_async_commit();

  // softmax: 4 threads a row (c = tid % 4); rows past the tile's run no
  // element but take part in the shuffles
  {
    const int r = tid >> 2;
    const int c = tid & 3;
    const int js = r < nq ? S : 0;
    float* col = sp + r;
    const float sum = softmax_exp<4, kLdP>(col, js, c).y;
    if (a.defer) {
      if (c == 0 && r < nq) srow[r] = sum;
    } else if (kDrop) {
      // a group whose e are all 0 (masked keys) stays 0, undrawn
      __syncwarp();
      const uint2 key = ldot::seed_key(a.seed);
      for (int g = c; 4 * g < js; g += 4) {
        if (all_zero<kLdP>(col, g, js)) continue;
        unsigned w[4];
        keep_words(w, key, g, i0 + r, h, b);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int u = (c + t) & 3;
          const int j = 4 * g + u;
          if (j < js) {
            const float e = col[j * kLdP];
            col[j * kLdP] = ldot::pick4(w, u) < a.thresh && e != 0.f
                                ? __fmul_rn(e / sum, a.mscale)
                                : 0.f;
          }
        }
      }
    } else {
      for (int j = c; j < js; j += 4) {
        const float e = col[j * kLdP];
        if (e != 0.f) col[j * kLdP] = e / sum;
      }
    }
  }
  if (vec) ldot::cp_async_wait<0>();
  __syncthreads();

  // out = P V
  pv_phase<kLdP, kPvRowsFwd>(sp, sv, D4, S, nq, D4,
                             a.out + base + static_cast<size_t>(i0) * rs, rs,
                             D, vec, a.defer ? srow : nullptr);
}

template <bool kDrop>
cudaError_t launch(const ldot::AttnFma& a, int batch, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be granted explicitly; grant
  // the largest supported shape once
  static cudaError_t granted = cudaFuncSetAttribute(
      attention_kernel<kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxSeq, kMaxHeadDim) * sizeof(float)));
  if (granted != cudaSuccess) return granted;
  const int tiles = (a.seq + kTile - 1) / kTile;
  const int vec = a.head_dim % 4 == 0 && ldot::aligned16(a.q) &&
                  ldot::aligned16(a.k) && ldot::aligned16(a.v) &&
                  ldot::aligned16(a.out);
  const size_t smem = smem_floats(a.seq, a.head_dim) * sizeof(float);
  attention_kernel<kDrop><<<batch * a.heads * tiles, kThreads, smem,
                            stream>>>(a, tiles, vec);
  return cudaGetLastError();
}

}  // namespace

cudaError_t ldot::attention_fma(const AttnFma& a, int batch,
                                cudaStream_t stream) {
  if (batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.head_dim <= 0 ||
      a.seq > kMaxSeq || a.head_dim > kMaxHeadDim ||
      (a.dropout && a.defer))
    return cudaErrorInvalidValue;
  return a.dropout ? launch<true>(a, batch, stream)
                   : launch<false>(a, batch, stream);
}

// q, k, v, out: [batch, seq, heads, head_dim] contiguous, float32 or
// bfloat16 (dtype code); bias: [batch, seq] float32 additive key bias.
// seq <= 256, head_dim <= 64 (bfloat16: a multiple of 8, 16-byte aligned).
extern "C" int ldot_attention(const void* q, const void* k, const void* v,
                              const float* bias, void* out, int batch,
                              int seq, int heads, int head_dim, float scale,
                              int defer, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
      seq > kMaxSeq || head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32) {
    const ldot::AttnFma a{static_cast<const float*>(q),
                          static_cast<const float*>(k),
                          static_cast<const float*>(v),
                          bias,
                          static_cast<float*>(out),
                          seq,
                          heads,
                          head_dim,
                          scale,
                          defer,
                          nullptr,
                          1.f,
                          0u,
                          0};
    return ldot::attention_fma(a, batch, s);
  }
  if (dtype == ldot::kBFloat16) {
    const ldot::AttnMma a{static_cast<const __nv_bfloat16*>(q),
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v),
                          bias,
                          static_cast<__nv_bfloat16*>(out),
                          seq,
                          heads,
                          head_dim,
                          scale,
                          nullptr,
                          1.f,
                          0u,
                          0};
    return ldot::attention_mma(a, batch, defer ? 0 : 1, s);
  }
  return cudaErrorInvalidValue;
}
