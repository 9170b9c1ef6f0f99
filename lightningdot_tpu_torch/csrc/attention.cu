// Self-attention for sequences up to 256 in float32, register-blocked on
// the FMA units, one block per (batch, head, tile of 64 queries): out =
// softmax(q k^T * scale + key_bias) v. The bfloat16 forms go to the
// tensor-core kernel (attention_mma.cu); the C entry below splits by dtype.
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
// after e v.
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

#include "attention_mma.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // query rows per block
constexpr int kLdP = kTile + 8;    // P [j][query] row stride, floats
constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// K [S][D4 + 4] (V [S][D4] over it once the scores are done), Q [kTile][D4
// + 4], P [S][kLdP], the row sums [kTile]; every part a multiple of 4 floats
__host__ __device__ constexpr size_t smem_floats(int seq, int head_dim) {
  return static_cast<size_t>(seq + kTile) * (round4(head_dim) + 4) +
         static_cast<size_t>(seq) * kLdP + kTile;
}

struct Attn {
  const float* q;        // [B, S, H, D] contiguous
  const float* k;
  const float* v;
  const float* bias;     // [B, S]
  float* out;            // [B, S, H, D]
  int seq, heads, head_dim, tiles;
  float scale;
  int defer;
  int vec;               // D % 4 == 0 and q, k, v, out 16-byte aligned
};

// one 16-query x 32-key chunk of scores with NY keys a thread (NY < 4 only
// in a last, partial chunk): sequential FMAs over d, then * scale, + bias
template <int NY>
__device__ __forceinline__ void score_chunk(const float* qp, const float* kp,
                                            int ldk, int d4, float scale,
                                            const float* brow, int kb, int S,
                                            float* pp) {
  float acc[4][NY];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < NY; ++y) acc[x][y] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 qv[4], kv[NY];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      qv[x] = *reinterpret_cast<const float4*>(qp + 4 * x * ldk + d);
#pragma unroll
    for (int y = 0; y < NY; ++y)
      kv[y] = *reinterpret_cast<const float4*>(kp + 8 * y * ldk + d);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < NY; ++y) {
        acc[x][y] = fmaf(qv[x].x, kv[y].x, acc[x][y]);
        acc[x][y] = fmaf(qv[x].y, kv[y].y, acc[x][y]);
        acc[x][y] = fmaf(qv[x].z, kv[y].z, acc[x][y]);
        acc[x][y] = fmaf(qv[x].w, kv[y].w, acc[x][y]);
      }
    }
  }
#pragma unroll
  for (int y = 0; y < NY; ++y) {
    const int j = kb + 8 * y;
    if (j >= S) break;
    const float bj = brow[j];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pp[j * kLdP + 4 * x] = __fadd_rn(__fmul_rn(acc[x][y], scale), bj);
  }
}

__global__ void __launch_bounds__(kThreads, 2) attention_kernel(Attn a) {
  extern __shared__ __align__(16) float smem[];
  const int S = a.seq;
  const int D = a.head_dim;
  const int D4 = round4(D);
  const int ldk = D4 + 4;
  float* sk = smem;                              // K [S][ldk]
  float* sv = smem;                              // V [S][D4], after scores
  float* sq = smem + static_cast<size_t>(S) * ldk;   // Q [kTile][ldk]
  float* sp = sq + kTile * ldk;                  // P [S][kLdP]
  float* srow = sp + S * kLdP;                   // [kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x % a.tiles;
  const int bh = blockIdx.x / a.tiles;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int i0 = tile * kTile;                   // first query row
  const int nq = min(kTile, S - i0);             // query rows in the tile
  const size_t rs = static_cast<size_t>(a.heads) * D;   // row stride
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;

  // Q and K as they lie, zero past the tile's rows and past D
  if (a.vec) {
    const int c4 = D / 4;
    const uint32_t dq = static_cast<uint32_t>(__cvta_generic_to_shared(sq));
    const uint32_t dk = static_cast<uint32_t>(__cvta_generic_to_shared(sk));
    for (int idx = tid; idx < kTile * c4; idx += kThreads) {
      const int i = idx / c4, c = idx % c4;
      const bool ok = i < nq;
      ldot::cp_async16(dq + (i * ldk + c * 4) * 4,
                       ok ? a.q + base + (i0 + i) * rs + c * 4 : a.q, ok);
    }
    for (int idx = tid; idx < S * c4; idx += kThreads) {
      const int j = idx / c4, c = idx % c4;
      ldot::cp_async16(dk + (j * ldk + c * 4) * 4,
                       a.k + base + j * rs + c * 4, true);
    }
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  } else {
    for (int idx = tid; idx < kTile * D4; idx += kThreads) {
      const int i = idx / D4, d = idx % D4;
      sq[i * ldk + d] =
          i < nq && d < D ? a.q[base + (i0 + i) * rs + d] : 0.f;
    }
    for (int idx = tid; idx < S * D4; idx += kThreads) {
      const int j = idx / D4, d = idx % D4;
      sk[j * ldk + d] = d < D ? a.k[base + j * rs + d] : 0.f;
    }
  }
  __syncthreads();

  // scores: a warp takes a 16-query x 32-key chunk at a time
  const float* brow = a.bias + static_cast<size_t>(b) * S;
  {
    const int ql = lane & 3, kl = lane >> 2;
    const int cq = (nq + 15) / 16;
    const int chunks = cq * ((S + 31) / 32);
    for (int ch = warp; ch < chunks; ch += kWarps) {
      const int qb = (ch % cq) * 16 + ql;
      const int kb0 = (ch / cq) * 32;
      const int kb = kb0 + kl;
      const float* qp = sq + qb * ldk;
      const float* kp = sk + kb * ldk;
      float* pp = sp + qb;
      const int ny = min(4, (S - kb0 + 7) / 8);   // keys a thread, uniform
      if (ny == 4)
        score_chunk<4>(qp, kp, ldk, D4, a.scale, brow, kb, S, pp);
      else if (ny == 3)
        score_chunk<3>(qp, kp, ldk, D4, a.scale, brow, kb, S, pp);
      else if (ny == 2)
        score_chunk<2>(qp, kp, ldk, D4, a.scale, brow, kb, S, pp);
      else
        score_chunk<1>(qp, kp, ldk, D4, a.scale, brow, kb, S, pp);
    }
  }
  __syncthreads();   // P complete; K no longer read

  // V over K's space, in flight during the softmax
  if (a.vec) {
    const int c4 = D / 4;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(sv));
    for (int idx = tid; idx < S * c4; idx += kThreads) {
      const int j = idx / c4, c = idx % c4;
      ldot::cp_async16(dst + (j * D4 + c * 4) * 4,
                       a.v + base + j * rs + c * 4, true);
    }
    ldot::cp_async_commit();
  } else {
    for (int idx = tid; idx < S * D4; idx += kThreads) {
      const int j = idx / D4, d = idx % D4;
      sv[idx] = d < D ? a.v[base + j * rs + d] : 0.f;
    }
  }

  // softmax: 4 threads a row (c = tid % 4 holds the partials of lanes c,
  // c + 4, ..., c + 28 of torch's warp softmax); rows past the tile's run
  // no element but take part in the shuffles
  {
    const int r = tid >> 2;
    const int c = tid & 3;
    const int js = r < nq ? S : 0;
    float* col = sp + r;
    float m = -INFINITY;
    for (int j = c; j < js; j += 4) m = fmaxf(m, col[j * kLdP]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float part[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) part[u] = 0.f;
    for (int j0 = 0; j0 < js; j0 += 32) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + c + 4 * u;
        if (j < js) {
          const float e = expf(col[j * kLdP] - m);
          col[j * kLdP] = e;
          part[u] = __fadd_rn(part[u], e);
        }
      }
    }
    // the butterfly: offsets 16, 8 and 4 inside the thread, 2 and 1 across
    const float s0 = __fadd_rn(part[0], part[4]);
    const float s1 = __fadd_rn(part[1], part[5]);
    const float s2 = __fadd_rn(part[2], part[6]);
    const float s3 = __fadd_rn(part[3], part[7]);
    float sum = __fadd_rn(__fadd_rn(s0, s2), __fadd_rn(s1, s3));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    if (a.defer) {
      if (c == 0 && r < nq) srow[r] = sum;
    } else {
      for (int j = c; j < js; j += 4) {
        const float e = col[j * kLdP];
        if (e != 0.f) col[j * kLdP] = e / sum;
      }
    }
  }
  if (a.vec) ldot::cp_async_wait<0>();
  __syncthreads();

  // out = P V: a warp takes 4 query octets x 8 head-dim quads at a time
  {
    const int ndq = D4 / 4;
    const int no = (nq + 7) / 8;
    const int co = (no + 3) / 4;
    const int chunks = co * ((ndq + 7) / 8);
    for (int ch = warp; ch < chunks; ch += kWarps) {
      const int qo = (ch % co) * 4 + (lane & 3);
      const int dq = (ch / co) * 8 + (lane >> 2);
      if (qo >= no || dq >= ndq) continue;
      float acc[8][4];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
      }
      const float* pp = sp + qo * 8;
      const float* vp = sv + dq * 4;
#pragma unroll 4
      for (int j = 0; j < S; ++j) {
        const float4 p0 = *reinterpret_cast<const float4*>(pp + j * kLdP);
        const float4 p1 =
            *reinterpret_cast<const float4*>(pp + j * kLdP + 4);
        const float4 vv = *reinterpret_cast<const float4*>(vp + j * D4);
        const float pa[8] = {p0.x, p0.y, p0.z, p0.w,
                             p1.x, p1.y, p1.z, p1.w};
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int x = 0; x < 8; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x][y] = fmaf(pa[x], va[y], acc[x][y]);
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int i = qo * 8 + x;
        if (i >= nq) break;
        float o[4];
#pragma unroll
        for (int y = 0; y < 4; ++y)
          o[y] = a.defer ? acc[x][y] / srow[i] : acc[x][y];
        float* dst = a.out + base + (i0 + i) * rs + dq * 4;
        if (a.vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
        } else {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (dq * 4 + y < D) dst[y] = o[y];
        }
      }
    }
  }
}

cudaError_t launch(const Attn& a, int batch, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be granted explicitly; grant
  // the largest supported shape once
  static cudaError_t granted = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxSeq, kMaxHeadDim) * sizeof(float)));
  if (granted != cudaSuccess) return granted;
  const size_t smem = smem_floats(a.seq, a.head_dim) * sizeof(float);
  attention_kernel<<<batch * a.heads * a.tiles, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

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
    const Attn a{static_cast<const float*>(q),
                 static_cast<const float*>(k),
                 static_cast<const float*>(v),
                 bias,
                 static_cast<float*>(out),
                 seq,
                 heads,
                 head_dim,
                 (seq + kTile - 1) / kTile,
                 scale,
                 defer,
                 head_dim % 4 == 0 && ldot::aligned16(q) &&
                     ldot::aligned16(k) && ldot::aligned16(v) &&
                     ldot::aligned16(out)};
    return launch(a, batch, s);
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
