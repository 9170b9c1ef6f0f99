// Training self-attention with dropout on the probabilities, forward and
// backward, on the raw [B, S, H*D] projections (the head split is done by
// strides; no reshape copy).
//
// Replaces the TPU kernels lightningdot_tpu/ops/experimental/
// attention_fused.py::_fwd_kernel (:117) and ::_bwd_kernel (:136), launched
// by _call (:221), and reproduces their rounding points (the plain twins are
// ops/attention_fused.py::_fused_attn_fwd_math and ::_fused_attn_bwd_math).
// bfloat16 runs on the tensor cores (the forward in attention_mma.cu, the
// backward in attention_mma_bwd.cu: the same rounding points, float32 sums
// in another order). float32, the dtype of training with --compute_dtype
// f32 (every layer of both towers at a dropout rate above 0), runs on the
// FMA units, bit-equal to the twins:
//   forward:  s = (q.k) * scale + key_bias, float32 softmax e / sum(e),
//             then p * keep * (1/(1-rate) in float32), out = dropped . v
//             accumulated in float32: attention.cu's register-blocked
//             kernel with its dropout pass (ldot::attention_fma);
//   backward: the forward recomputed; dv = dropped^T . g; dp = (g . v^T) *
//             keep * (1/(1-rate) in float32); ds = p * (dp - sum(dp * p));
//             ds * scale before dq = ds . k and dk = ds^T . q: the two
//             kernels below.
// The keep mask comes from counter-based Philox4x32-10 (philox.cuh), one
// draw per (batch item, head, row, column), a pure function of its
// coordinates: the forward and both backward kernels, each blocked its own
// way, regenerate the same mask in registers; it never reaches memory. The
// seed is read from device memory, so a layer never waits on the host.
//
// Bound: at the training shapes (B 64-128, S 32 / 64 / 104, up to 256; H
// 12, D 64) the forward moves 4 B S H D elements and does 4 B H S^2 D
// flops, the backward 7 B S H D elements and at least 10 B H S^2 D flops
// (the scores recomputed once): 10-100 flops per byte, so the float32 FMA
// rate bounds these kernels, not the memory.
//
// The backward's design (attention_fma.cuh's building blocks: every product
// in 4 x 4 or 8 x 4 register microtiles fed by 128-bit shared-memory loads,
// every sum in the twin's order). The work splits so that every chain has a
// fixed order and no atomics: dq by query tiles, dk and dv by key tiles,
// each block one (batch item, head, tile), the tiles of a head adjacent in
// the grid so that they find its operands in L2.
//   bwd_q:  stages G's tile and V by cp.async, computes dp = G V^T into DS
//           [S][kLd] (the tile's queries minor), then Q's tile and K over
//           them, the scores into P [S][kLd]; R = 256 / tile threads a row
//           take the softmax (warp order), the keep mask (one Philox draw
//           per 4 keys, the R threads of a row in distinct banks),
//           delta = sum(dp * p) (warp order) and ds * scale in place; dq =
//           DS^T K. Writes each row's max, sum and delta.
//   bwd_kv: stages V's tile and G, computes dp^T into DS [S][kLd] (the
//           tile's keys minor), then K's tile and Q, the scores into P; p =
//           exp(s - max) / sum from the stored statistics, bit-equal to
//           bwd_q's (the same score, max and sum), then dropped and ds in
//           place, a float4 of keys and one Philox draw a thread; dk = DS^T
//           Q, then G restaged over Q, dv = P^T G.
// The P^T V products run in 4 x 4 microtiles, so that a 64-row tile keeps
// all 256 threads busy. Groups of 4 keys whose probabilities are all 0
// (masked keys) take no Philox draw: p = 0 makes dropped, ds and the
// group's terms of delta 0 whatever the mask says.
// Development comparisons on an H100 80GB HBM3 at 700 W (not kept): 8 x 4
// P^T V microtiles were as fast at 64-row tiles and 11-13 % slower at
// 32-row tiles and at head dim 32; the Philox round keys computed once a
// thread gained nothing; without dropout bwd_q takes ~9 % and bwd_kv ~4 %
// less time at [128, 104].
// The dk/dv kernel recomputes g v^T rather than read it: handing dp (or ds)
// over from bwd_q means writing and reading B H S^2 floats, 33 MB a layer
// at [64, 104], about 20 us at 3.35 TB/s against the ~16 us that the
// recomputed product costs at the float32 peak, and a 33 MB scratch. So the
// design does 14 B H S^2 D flops (bwd_q 6, bwd_kv 8) where 10 would do.
// Tiles: 64 rows where two 8-warp blocks of each kernel share an SM (S <=
// 112 at D 64), else 32 (8 threads a softmax row). Shared memory at D 64:
// tile ld + round8(S) ld + 2 S kLd floats (ld = 68; kLd = tile + tile / 8),
// + 3 S for bwd_kv: at S 104 (tile 64) 105,600 B and 106,848 B, two blocks
// an SM; at S 256 (tile 32) 152,064 B and 155,136 B, one.
#include <cstdint>

#include "attention_fma.cuh"
#include "attention_mma.cuh"
#include "philox.cuh"

namespace {

using namespace ldot::fma;

// the shared memory two blocks of a kernel may each take on an SM (228 KB,
// less 1 KB a block the runtime keeps)
constexpr size_t kTwoBlockBytes = 113 * 1024;
constexpr int kPvRowsBwd = 4;      // rows of a P^T V microtile

struct Bwd {
  const float* q;           // [B, S, H*D] contiguous, as g, dq, dk, dv
  const float* k;
  const float* v;
  const float* g;
  const float* bias;        // [B, S] additive key bias
  const long long* seed;    // one int64 on the device; read iff dropout
  float* dq;
  float* dk;
  float* dv;
  float* stats;             // [3, B*H, S]: each row's max, sum, delta
  int seq, heads, head_dim;
  float scale;
  float mscale;             // 1 / (1 - rate) rounded to float32
  unsigned thresh;          // keep iff the Philox word < thresh
  int dropout;
  int tiles;                // ceil(seq / tile)
  int vec;                  // head_dim % 4 == 0, every tensor 16-byte aligned
};

__host__ __device__ constexpr int ld_p(int tile) { return tile + tile / 8; }

size_t bwd_q_floats(int tile, int seq, int head_dim) {
  return static_cast<size_t>(tile + round8(seq)) * operand_ld(head_dim) +
         static_cast<size_t>(2) * seq * ld_p(tile);
}

size_t bwd_kv_floats(int tile, int seq, int head_dim) {
  return bwd_q_floats(tile, seq, head_dim) + static_cast<size_t>(3) * seq;
}

int bwd_tile(int seq, int head_dim) {
  return bwd_kv_floats(64, seq, head_dim) * sizeof(float) <= kTwoBlockBytes
             ? 64
             : 32;
}

// dq for a tile of query rows, and per row: softmax max, sum, sum(dp * p)
template <int kTile>
__global__ void __launch_bounds__(kThreads, 2) bwd_q_kernel(Bwd a) {
  constexpr int R = kThreads / kTile;    // threads a softmax row
  constexpr int kLd = ld_p(kTile);
  extern __shared__ __align__(16) float smem[];
  const int S = a.seq, D = a.head_dim, D4 = round4(D), ld = operand_ld(D);
  float* sx = smem;                              // G's tile, then Q's
  float* sy = sx + kTile * ld;                   // V, then K [round8(S)]
  float* sp = sy + round8(S) * ld;               // p [S][kLd]
  float* sd = sp + S * kLd;                      // dp, then ds [S][kLd]

  const int tile = blockIdx.x % a.tiles;
  const int bh = blockIdx.x / a.tiles;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int i0 = tile * kTile;
  const int nq = min(kTile, S - i0);
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;

  stage(a.g, base, rs, i0, nq, kTile, D, ld, sx, a.vec);
  stage(a.v, base, rs, 0, S, round8(S), D, ld, sy, a.vec);
  if (a.vec) {
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  }
  __syncthreads();
  score_phase<kLd, kRaw>(sx, nq, sy, S, ld, D4, 1.f, nullptr, sd);
  __syncthreads();
  stage(a.q, base, rs, i0, nq, kTile, D, ld, sx, a.vec);
  stage(a.k, base, rs, 0, S, round8(S), D, ld, sy, a.vec);
  if (a.vec) {
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  }
  __syncthreads();
  score_phase<kLd, kBiasCol>(sx, nq, sy, S, ld, D4, a.scale,
                             a.bias + static_cast<size_t>(b) * S, sp);
  __syncthreads();

  // the rows: R threads each (c = the thread's place), in one warp
  {
    const int r = threadIdx.x / R;
    const int c = threadIdx.x % R;
    const int js = r < nq ? S : 0;
    float* pc = sp + r;
    float* dc = sd + r;
    const float2 ms = softmax_exp<R, kLd>(pc, js, c);
    if (a.dropout) {
      // dp * keep * mscale: groups of 4 keys g = c, c + R, ..., each
      // walked from element c on (mod 4), one Philox draw a group; a
      // group whose e are all 0 (masked keys) keeps its dp undrawn, as
      // p = 0 leaves its ds and its term of delta 0 either way
      __syncwarp();
      const uint2 key = ldot::seed_key(a.seed);
      for (int g = c; 4 * g < js; g += R) {
        if (all_zero<kLd>(pc, g, js)) continue;
        unsigned w[4];
        keep_words(w, key, g, i0 + r, h, b);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int u = (c + t) & 3;
          const int j = 4 * g + u;
          if (j < js)
            dc[j * kLd] = ldot::pick4(w, u) < a.thresh
                              ? __fmul_rn(dc[j * kLd], a.mscale)
                              : 0.f;
        }
      }
      __syncwarp();
    }
    // p = e / sum in place, and delta = sum(dp * p) in the warp's order
    float part[32 / R];
#pragma unroll
    for (int u = 0; u < 32 / R; ++u) part[u] = 0.f;
    for (int j0 = 0; j0 < js; j0 += 32) {
#pragma unroll
      for (int u = 0; u < 32 / R; ++u) {
        const int j = j0 + c + R * u;
        if (j < js) {
          float p = pc[j * kLd];
          if (p != 0.f) {
            p = p / ms.y;
            pc[j * kLd] = p;
          }
          part[u] = __fadd_rn(part[u], __fmul_rn(dc[j * kLd], p));
        }
      }
    }
    const float delta = warp_order_sum<R>(part);
    for (int j = c; j < js; j += R)
      dc[j * kLd] = __fmul_rn(
          __fmul_rn(pc[j * kLd], __fsub_rn(dc[j * kLd], delta)), a.scale);
    if (c == 0 && r < nq) {
      const size_t n_rows = static_cast<size_t>(gridDim.x / a.tiles) * S;
      const size_t at = static_cast<size_t>(bh) * S + i0 + r;
      a.stats[at] = ms.x;
      a.stats[n_rows + at] = ms.y;
      a.stats[2 * n_rows + at] = delta;
    }
  }
  __syncthreads();

  pv_phase<kLd, kPvRowsBwd>(sd, sy, ld, S, nq, D4,
                            a.dq + base + static_cast<size_t>(i0) * rs, rs,
                            D, a.vec, nullptr);
}

// dk and dv for a tile of key columns
template <int kTile>
__global__ void __launch_bounds__(kThreads, 2) bwd_kv_kernel(Bwd a) {
  constexpr int kLd = ld_p(kTile);
  extern __shared__ __align__(16) float smem[];
  const int S = a.seq, D = a.head_dim, D4 = round4(D), ld = operand_ld(D);
  float* sx = smem;                              // V's tile, then K's
  float* sy = sx + kTile * ld;                   // G, Q, G [round8(S)]
  float* sp = sy + round8(S) * ld;               // s, then dropped [S][kLd]
  float* sd = sp + S * kLd;                      // dp, then ds [S][kLd]
  float* sm = sd + S * kLd;                      // max, sum, delta [S] each
  float* sl = sm + S;
  float* sdel = sl + S;

  const int tile = blockIdx.x % a.tiles;
  const int bh = blockIdx.x / a.tiles;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int j0 = tile * kTile;
  const int nk = min(kTile, S - j0);
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;

  stage(a.v, base, rs, j0, nk, kTile, D, ld, sx, a.vec);
  stage(a.g, base, rs, 0, S, round8(S), D, ld, sy, a.vec);
  if (a.vec) ldot::cp_async_commit();
  {
    const size_t n_rows = static_cast<size_t>(gridDim.x / a.tiles) * S;
    const size_t at = static_cast<size_t>(bh) * S;
    for (int i = threadIdx.x; i < S; i += kThreads) {
      sm[i] = a.stats[at + i];
      sl[i] = a.stats[n_rows + at + i];
      sdel[i] = a.stats[2 * n_rows + at + i];
    }
  }
  if (a.vec) ldot::cp_async_wait<0>();
  __syncthreads();
  score_phase<kLd, kRaw>(sx, nk, sy, S, ld, D4, 1.f, nullptr, sd);
  __syncthreads();
  stage(a.k, base, rs, j0, nk, kTile, D, ld, sx, a.vec);
  stage(a.q, base, rs, 0, S, round8(S), D, ld, sy, a.vec);
  if (a.vec) {
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  }
  __syncthreads();
  score_phase<kLd, kBiasRow>(sx, nk, sy, S, ld, D4, a.scale,
                             a.bias + static_cast<size_t>(b) * S + j0, sp);
  __syncthreads();

  // p from the row statistics, then the dropped probabilities and ds * scale
  // in place: a thread takes 4 keys of a row, one Philox draw
  {
    const uint2 key = a.dropout ? ldot::seed_key(a.seed) : make_uint2(0, 0);
    const int ng = (nk + 3) / 4;
    for (int idx = threadIdx.x; idx < S * ng; idx += kThreads) {
      const int i = idx / ng, g = idx % ng;
      float4* pp = reinterpret_cast<float4*>(sp + i * kLd + 4 * g);
      float4* dp = reinterpret_cast<float4*>(sd + i * kLd + 4 * g);
      float s[4] = {pp->x, pp->y, pp->z, pp->w};
      float d[4] = {dp->x, dp->y, dp->z, dp->w};
      const float m = sm[i], l = sl[i], del = sdel[i];
      float p4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p4[e] = expf(s[e] - m) / l;
      // no draw where the four p are 0: dropped and ds are 0 either way
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (a.dropout && (p4[0] != 0.f || p4[1] != 0.f || p4[2] != 0.f ||
                        p4[3] != 0.f))
        keep_words(w, key, (j0 >> 2) + g, i, h, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = p4[e];
        const bool keep = !a.dropout || w[e] < a.thresh;
        const float dpk =
            !a.dropout ? d[e] : keep ? __fmul_rn(d[e], a.mscale) : 0.f;
        s[e] = !a.dropout ? p : keep ? __fmul_rn(p, a.mscale) : 0.f;
        d[e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dpk, del)), a.scale);
      }
      *pp = make_float4(s[0], s[1], s[2], s[3]);
      *dp = make_float4(d[0], d[1], d[2], d[3]);
    }
  }
  __syncthreads();

  pv_phase<kLd, kPvRowsBwd>(sd, sy, ld, S, nk, D4,
                            a.dk + base + static_cast<size_t>(j0) * rs, rs,
                            D, a.vec, nullptr);
  __syncthreads();
  stage(a.g, base, rs, 0, S, round8(S), D, ld, sy, a.vec);
  if (a.vec) {
    ldot::cp_async_commit();
    ldot::cp_async_wait<0>();
  }
  __syncthreads();
  pv_phase<kLd, kPvRowsBwd>(sp, sy, ld, S, nk, D4,
                            a.dv + base + static_cast<size_t>(j0) * rs, rs,
                            D, a.vec, nullptr);
}

// above 48 KB a block's shared memory must be granted explicitly; grant
// each kernel the most its tile is used at once: tile 64 only where two
// blocks fit (bwd_tile), tile 32 up to the largest shape
template <typename K>
cudaError_t grant(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  cudaGetLastError();   // a refusal must not stay behind as the last error
  return err;
}

template <int kTile>
size_t granted_bytes(size_t (*floats)(int, int, int)) {
  return kTile == 64 ? kTwoBlockBytes
                     : floats(kTile, kMaxSeq, kMaxHeadDim) * sizeof(float);
}

template <int kTile>
cudaError_t launch_bwd(Bwd a, int batch, cudaStream_t stream) {
  static cudaError_t granted_q =
      grant(bwd_q_kernel<kTile>, granted_bytes<kTile>(bwd_q_floats));
  static cudaError_t granted_kv =
      grant(bwd_kv_kernel<kTile>, granted_bytes<kTile>(bwd_kv_floats));
  if (granted_q != cudaSuccess) return granted_q;
  if (granted_kv != cudaSuccess) return granted_kv;
  a.tiles = (a.seq + kTile - 1) / kTile;
  const int grid = batch * a.heads * a.tiles;
  bwd_q_kernel<kTile><<<grid, kThreads,
                        bwd_q_floats(kTile, a.seq, a.head_dim) *
                            sizeof(float),
                        stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<kTile><<<grid, kThreads,
                         bwd_kv_floats(kTile, a.seq, a.head_dim) *
                             sizeof(float),
                         stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int batch, int seq, int heads, int head_dim) {
  return batch <= 0 || seq <= 0 || heads <= 0 || head_dim <= 0 ||
         seq > kMaxSeq || head_dim > kMaxHeadDim;
}

}  // namespace

// q, k, v, out: [batch, seq, heads * head_dim] contiguous, float32 or
// bfloat16 (dtype code); bias: [batch, seq] float32; seed: one int64 on the
// device. seq <= 256, head_dim <= 64 (bfloat16: a multiple of 8, 16-byte
// aligned).
extern "C" int ldot_attention_train_fwd(
    const void* q, const void* k, const void* v, const float* bias,
    const long long* seed, void* out, int batch, int seq, int heads,
    int head_dim, float scale, float mscale, unsigned thresh, int dropout,
    int dtype, void* stream) {
  if (bad_shape(batch, seq, heads, head_dim)) return cudaErrorInvalidValue;
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
                          0,
                          seed,
                          mscale,
                          thresh,
                          dropout};
    return ldot::attention_fma(a, batch, s);
  }
  if (dtype == ldot::kBFloat16) {
    const ldot::AttnMma m{static_cast<const __nv_bfloat16*>(q),
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v),
                          bias,
                          static_cast<__nv_bfloat16*>(out),
                          seq,
                          heads,
                          head_dim,
                          scale,
                          seed,
                          mscale,
                          thresh,
                          dropout};
    return ldot::attention_mma(m, batch, 1, s);
  }
  return cudaErrorInvalidValue;
}

// as above, with g, dq, dk, dv: [batch, seq, heads * head_dim] and stats:
// float32 scratch of 3 * batch * heads * seq (per-row max, sum, sum(dp p));
// bfloat16 on the tensor cores (the same needs as the forward, g, dq, dk and
// dv 16-byte aligned too)
extern "C" int ldot_attention_train_bwd(
    const void* q, const void* k, const void* v, const float* bias,
    const long long* seed, const void* g, void* dq, void* dk, void* dv,
    float* stats, int batch, int seq, int heads, int head_dim, float scale,
    float mscale, float mscale_f32, unsigned thresh, int dropout, int dtype,
    void* stream) {
  if (bad_shape(batch, seq, heads, head_dim)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32) {
    const Bwd a{static_cast<const float*>(q),
                static_cast<const float*>(k),
                static_cast<const float*>(v),
                static_cast<const float*>(g),
                bias,
                seed,
                static_cast<float*>(dq),
                static_cast<float*>(dk),
                static_cast<float*>(dv),
                stats,
                seq,
                heads,
                head_dim,
                scale,
                mscale_f32,
                thresh,
                dropout,
                0,
                head_dim % 4 == 0 && ldot::aligned16(q) &&
                    ldot::aligned16(k) && ldot::aligned16(v) &&
                    ldot::aligned16(g) && ldot::aligned16(dq) &&
                    ldot::aligned16(dk) && ldot::aligned16(dv)};
    return bwd_tile(seq, head_dim) == 64 ? launch_bwd<64>(a, batch, s)
                                         : launch_bwd<32>(a, batch, s);
  }
  if (dtype == ldot::kBFloat16) {
    const ldot::AttnMmaBwd m{static_cast<const __nv_bfloat16*>(q),
                             static_cast<const __nv_bfloat16*>(k),
                             static_cast<const __nv_bfloat16*>(v),
                             static_cast<const __nv_bfloat16*>(g),
                             bias,
                             seed,
                             static_cast<__nv_bfloat16*>(dq),
                             static_cast<__nv_bfloat16*>(dk),
                             static_cast<__nv_bfloat16*>(dv),
                             stats,
                             seq,
                             heads,
                             head_dim,
                             scale,
                             mscale,
                             mscale_f32,
                             thresh,
                             dropout};
    return ldot::attention_mma_bwd(m, batch, s);
  }
  return cudaErrorInvalidValue;
}
