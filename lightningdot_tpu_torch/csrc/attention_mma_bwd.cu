// bfloat16 training-attention backward on the tensor cores, for sequences up
// to 256 and head_dim up to 64: dq, dk, dv of out = dropout(softmax(q k^T *
// scale + key_bias)) v, the dropout mask regenerated from the seed.
//
// Replaces, in bfloat16, the TPU kernel lightningdot_tpu/ops/experimental/
// attention_fused.py::_bwd_kernel (:136; launched by _call, :221), through
// ldot_attention_train_bwd (attention_fused.cu). The float32 form stays on
// that file's FMA kernels, bit-equal to the twin.
//
// Rounding points, as the twin (ops/attention_fused.py::_fused_attn_bwd_math):
// s = (q . k) * scale + bias in float32; the row's global max, e = exp(s -
// max), its float32 sum, p = e / sum (IEEE) un-rounded; dropped = p rounded
// to bf16, then round_bf16(dropped * mscale) where the Philox word keeps it,
// else 0: the bf16 A operand of dV = dropped^T G; dp = (G V^T) left in
// float32, * mscale_f32 where kept, else 0: a float32 accumulator; delta =
// sum_j dp p (the kernel's own float32 values, not rowsum(g o out)); ds = p
// (dp - delta), ds * scale rounded to bf16: the bf16 A operand of dQ = dS K
// and dK = dS^T Q. Only the order of the float32 sums differs from the twin.
//
// Bound: per head the backward moves 7 S D bf16 elements (q, k, v, g in;
// dq, dk, dv out) and does 10 S^2 D flops (the scores twice): S / 1.4 <= 183
// flops per byte, below the card's ridge (~295), so the bytes bound it at
// every path shape: 13.2 us at [64, 64, 12, 64], 21.4 us at [64, 104].
//
// Design: two kernels, as the FMA form, and no atomics (the same inputs give
// the same bits on every launch). Both take one (batch item, head) and a
// tile of up to 64 rows per block, one warp per 16 rows, and stage the
// tile's two operands and the other side's two whole operands as bf16 in
// swizzled shared memory (D padded to 64, S to a multiple of 16, zeros by
// cp.async): 81 KB at S 256 against the FMA kernels' 215-218 KB. Every
// product is mma.sync m16n8k16 (mma.cuh), the streamed side in chunks of 32
// columns:
//   dq kernel (rows = queries): S = Q K^T and dP = G V^T with K and V read
//     non-transposed, as K in the forward; dQ += dS K with dS repacked from
//     the accumulators and K by ldmatrix.trans, as V in the forward's P V.
//     The row's global max comes before any e and the sum before any p.
//     Up to 128 keys the row's scores and dp stay in registers (a template
//     bucket of 1, 2 or 4 chunks), each product, exp, division and Philox
//     draw done once; above, a full-row tile and its dP would not fit (the
//     forward's score tile alone took 189 registers at S 256), so the keys
//     are walked in passes: scores to the max; scores to the sum; scores
//     and dP to delta; scores and dP to dS and dQ, the products recomputed
//     on each pass. Both forms sum in the same order: the same bits. It
//     writes each row's max, sum and delta.
//   dk/dv kernel (rows = keys): S^T = K Q^T and dP^T = V G^T with Q and G
//     read non-transposed; p from the dq kernel's statistics; dV += dropped^T
//     G and dK += dS^T Q with the repacked accumulators as A, G and Q by
//     ldmatrix.trans. The queries stream in chunks; only dK and dV stay.
// The keep mask is Philox word j % 4 of counter (j / 4, i, head, item) for
// query i and key j (philox.cuh): the dq kernel draws it as the forward
// does (keep_words_qk), the dk/dv kernel in its transposed layout, keys as
// rows (keep_words_kq: one call per lane, a 4 x 4 transpose by shuffles).
// The dk/dv kernel recomputes p from K Q^T, which the tensor cores are not
// guaranteed to sum as Q K^T: its p may differ from the dq kernel's in the
// last bit. Nothing here forces them equal; chip_smoke.py's tolerance (a
// bf16 ulp) and accuracy check (relative L2 to float32 within 1.1x the
// twin's) hold the result. Padding: padded keys score -inf (p exactly 0)
// with zero K and V rows; padded query rows are zero Q and G rows (their ds
// and dV terms are exactly 0) with statistics (0, 1, 0); padded rows are
// never written.
// Registers (ptxas -Xptxas -v, sm_90a; chip_smoke.py's `resources` rows
// print them on every run): the dk/dv kernel and the 4-chunk dq kernel are
// bounded to 168, so 3 blocks share an SM, at the cost of a few spilled
// bytes (unbounded they took 175 and 196 at 2 blocks per SM, and were
// slower in a development comparison on an H100, not kept; reloading K
// and V fragments per chunk instead of holding them did not help).
#include <cstdint>

#include "attention_mma.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kRowBytes = kMaxHeadDim * 2;   // a staged row, D padded to 64
constexpr int kMaxRows = 64;                 // rows per block
constexpr int kKs = kMaxHeadDim / 16;        // k16 steps over the head dim
constexpr int kDn = kMaxHeadDim / 8;         // n8 tiles over the head dim
constexpr unsigned kFull = 0xffffffffu;

using ldot::cp_async_commit;
using ldot::cp_async_wait;
using ldot::load_a;
using ldot::load_b_kn;
using ldot::load_b_nk;
using ldot::mma_bf16;
using ldot::repack_a;
using ldot::round_to;
using Bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int padded(int seq) {
  return (seq + 15) / 16 * 16;
}

int tile_rows(int seq) { return seq >= kMaxRows ? kMaxRows : padded(seq); }

size_t dq_smem(int rows, int spad) {
  return static_cast<size_t>(2 * rows + 2 * spad) * kRowBytes +
         static_cast<size_t>(spad) * sizeof(float);
}

size_t dkv_smem(int rows, int spad) {
  return static_cast<size_t>(2 * rows + 2 * spad) * kRowBytes +
         static_cast<size_t>(3 * spad + rows) * sizeof(float);
}

__device__ __forceinline__ void zero(float (&x)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
  }
}

// acc[n] += the warp's 16 rows (A fragments a) times the 32 staged rows of
// chunk c of `side` ([S][D], read non-transposed as B): n8 tile n holds
// columns 32 c + 8 n .. + 7; blocks of 16 at or past nb are skipped
__device__ __forceinline__ void chunk_product(float (&acc)[4][4],
                                              const uint32_t (&a)[kKs][4],
                                              uint32_t side, int c, int nb,
                                              int nks, int lane) {
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    if (ks < nks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * c + h < nb) {
          uint32_t f[4];
          load_b_nk<8>(f, side, 32 * c + 16 * h, ks, lane);
          mma_bf16(acc[2 * h], a[ks], f[0], f[1]);
          mma_bf16(acc[2 * h + 1], a[ks], f[2], f[3]);
        }
      }
    }
  }
}

// out[n] += A (the 16 x 32 chunk c, in the accumulator layout x) times the
// chunk's 32 staged rows of `side` ([S][D], by ldmatrix.trans)
__device__ __forceinline__ void chunk_times(float (&out)[kDn][4],
                                            const float (&x)[4][4],
                                            uint32_t side, int c, int nb,
                                            int nks, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (2 * c + h < nb) {
      uint32_t xa[4];
      repack_a(xa, x[2 * h], x[2 * h + 1]);
#pragma unroll
      for (int dd = 0; dd < kKs; ++dd) {
        if (dd < nks) {
          uint32_t f[4];
          load_b_kn<8>(f, side, 16 * dd, 2 * c + h, lane);
          mma_bf16(out[2 * dd], xa, f[0], f[1]);
          mma_bf16(out[2 * dd + 1], xa, f[2], f[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// the tile's rows [r0, r0 + 16) of out ([B, S, H*D] at base), from the
// accumulators o (row g + 8 (e / 2), column 8 n + 2 t + e % 2)
__device__ __forceinline__ void store_rows(Bf16* out, size_t base, size_t rs,
                                           const float (&o)[kDn][4], int r0,
                                           int S, int D, int g, int t) {
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
    const int d = 8 * n + 2 * t;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + g + 8 * r;
        if (i < S)
          *reinterpret_cast<__nv_bfloat162*>(
              out + base + static_cast<size_t>(i) * rs + d) =
              __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

// s = acc * scale + bias for chunk c of the keys; n8 tiles past the padded
// keys score -inf
__device__ __forceinline__ void scale_bias(float (&s)[4][4], int c, int nb,
                                           int t, const float* sbias,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int j = 32 * c + 8 * n + 2 * t;
    if (2 * c + (n >> 1) < nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), sbias[j + (e & 1)]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = -INFINITY;
    }
  }
}

// chunk c's p into x (from the scores, or kFromE: from e = exp(s - max))
// and dp into dpr (G V^T, * mscale_f32 where kept, else 0); del += dp p
template <bool kFromE>
__device__ __forceinline__ void probs(float (&x)[4][4], float (&dpr)[4][4],
                                      float (&del)[2], const float (&mx)[2],
                                      const float (&sum)[2],
                                      const ldot::AttnMmaBwd& a, uint2 key,
                                      int row, int c, int t, int h, int b) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
    if (a.dropout) ldot::keep_words_qk(w, key, row, 32 * c + 8 * n, t, h, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ex = kFromE ? x[n][e] : expf(x[n][e] - mx[e >> 1]);
      const float p = __fdiv_rn(ex, sum[e >> 1]);
      float dp = dpr[n][e];
      if (a.dropout) dp = w[e] < a.thresh ? __fmul_rn(dp, a.mscale_f32) : 0.f;
      x[n][e] = p;
      dpr[n][e] = dp;
      del[e >> 1] = __fadd_rn(del[e >> 1], __fmul_rn(dp, p));
    }
  }
}

// ds = round_bf16(p (dp - delta) * scale) into x
__device__ __forceinline__ void dscores(float (&x)[4][4],
                                        const float (&dpr)[4][4],
                                        const float (&del)[2], float scale) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[n][e] = round_to<Bf16>(__fmul_rn(
          __fmul_rn(x[n][e], __fsub_rn(dpr[n][e], del[e >> 1])), scale));
  }
}

// dq for a tile of query rows, and per row: max, sum and delta. NC > 0:
// the row's scores and dp stay in registers, NC chunks of 32 keys (S up to
// 32 NC), each product, exp, division and Philox draw done once; NC = 0:
// the keys are walked in passes, the products recomputed on each. MINB:
// blocks per SM the registers must allow
template <int NC, int MINB>
__global__ void __launch_bounds__(kMaxRows / 16 * 32, MINB)
    bwd_dq_kernel(ldot::AttnMmaBwd a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.seq, D = a.head_dim;
  const int spad = padded(S);
  const int nb = spad / 16;                // key blocks of 16
  const int nch = (nb + 1) / 2;            // chunks of 32 keys
  const int nks = (D + 15) / 16;
  const int rows = blockDim.x / 32 * 16;
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sg = sq + rows * kRowBytes;
  const uint32_t sk = sg + rows * kRowBytes;
  const uint32_t sv = sk + spad * kRowBytes;
  float* sbias =
      reinterpret_cast<float*>(smem + (2 * rows + 2 * spad) * kRowBytes);

  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int i0 = blockIdx.y * rows;
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  const int chunks = D / 8;

  // (Q, K) for the max and sum, then (G, V)
  ldot::stage<8>(a.q, base, rs, i0, rows, S - i0, chunks, sq);
  ldot::stage<8>(a.k, base, rs, 0, spad, S, chunks, sk);
  cp_async_commit();
  ldot::stage<8>(a.g, base, rs, i0, rows, S - i0, chunks, sg);
  ldot::stage<8>(a.v, base, rs, 0, spad, S, chunks, sv);
  cp_async_commit();
  for (int j = threadIdx.x; j < spad; j += blockDim.x)
    sbias[j] = j < S ? a.bias[static_cast<size_t>(b) * S + j] : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const bool active = i0 + wr < S;
  const int row = i0 + wr + g;
  uint32_t qa[kKs][4], ga[kKs][4];
  float mx[2] = {-INFINITY, -INFINITY};
  float sum[2] = {0.f, 0.f};
  float del[2] = {0.f, 0.f};
  float o[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
  // held: the scores, then e, p and ds (x), and dp (y), chunk by chunk
  constexpr int kHeld = NC > 0 ? NC : 1;
  float x[kHeld][4][4], y[kHeld][4][4];

  if (active) {
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
      if (ks < nks) load_a<8>(qa[ks], sq, wr, ks, lane);
    // the row's max, then e = exp(s - max) and its sum
    if constexpr (NC > 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nch) {
          chunk_product(x[c], qa, sk, c, nb, nks, lane);
          scale_bias(x[c], c, nb, t, sbias, a.scale);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mx[e >> 1] = fmaxf(mx[e >> 1], x[c][n][e]);
          }
        }
      }
    } else {
      for (int c = 0; c < nch; ++c) {
        chunk_product(x[0], qa, sk, c, nb, nks, lane);
        scale_bias(x[0], c, nb, t, sbias, a.scale);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], x[0][n][e]);
        }
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    if constexpr (NC > 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nch) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x[c][n][e] = expf(x[c][n][e] - mx[e >> 1]);
              sum[e >> 1] += x[c][n][e];
            }
          }
        }
      }
    } else {
      for (int c = 0; c < nch; ++c) {
        chunk_product(x[0], qa, sk, c, nb, nks, lane);
        scale_bias(x[0], c, nb, t, sbias, a.scale);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[e >> 1] += expf(x[0][n][e] - mx[e >> 1]);
        }
      }
    }
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

#pragma unroll
  for (int ks = 0; ks < kKs; ++ks)
    if (ks < nks) load_a<8>(ga[ks], sg, wr, ks, lane);
  const uint2 key = a.dropout ? ldot::seed_key(a.seed) : make_uint2(0, 0);
  // p, dp and delta; then ds and dQ += dS K
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nch) {
        chunk_product(y[c], ga, sv, c, nb, nks, lane);
        probs<true>(x[c], y[c], del, mx, sum, a, key, row, c, t, h, b);
      }
    }
    del[0] = quad_sum(del[0]);
    del[1] = quad_sum(del[1]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < nch) {
        dscores(x[c], y[c], del, a.scale);
        chunk_times(o, x[c], sk, c, nb, nks, lane);
      }
    }
  } else {
    float unused[2] = {0.f, 0.f};
    for (int c = 0; c < nch; ++c) {
      chunk_product(x[0], qa, sk, c, nb, nks, lane);
      scale_bias(x[0], c, nb, t, sbias, a.scale);
      chunk_product(y[0], ga, sv, c, nb, nks, lane);
      probs<false>(x[0], y[0], del, mx, sum, a, key, row, c, t, h, b);
    }
    del[0] = quad_sum(del[0]);
    del[1] = quad_sum(del[1]);
    for (int c = 0; c < nch; ++c) {
      chunk_product(x[0], qa, sk, c, nb, nks, lane);
      scale_bias(x[0], c, nb, t, sbias, a.scale);
      chunk_product(y[0], ga, sv, c, nb, nks, lane);
      probs<false>(x[0], y[0], unused, mx, sum, a, key, row, c, t, h, b);
      dscores(x[0], y[0], del, a.scale);
      chunk_times(o, x[0], sk, c, nb, nks, lane);
    }
  }

  store_rows(a.dq, base, rs, o, i0 + wr, S, D, g, t);
  if (t == 0) {
    const size_t n_rows = static_cast<size_t>(gridDim.x) * S;
    const size_t at = static_cast<size_t>(bh) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row + 8 * r;
      if (i < S) {
        a.stats[at + i] = mx[r];
        a.stats[n_rows + at + i] = sum[r];
        a.stats[2 * n_rows + at + i] = del[r];
      }
    }
  }
}

// dk and dv for a tile of key rows; at most 168 registers, so 3 blocks
// share an SM where shared memory allows (S <= 128)
__global__ void __launch_bounds__(kMaxRows / 16 * 32, 3)
    bwd_dkv_kernel(ldot::AttnMmaBwd a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.seq, D = a.head_dim;
  const int spad = padded(S);
  const int nb = spad / 16;                // query blocks of 16
  const int nch = (nb + 1) / 2;            // chunks of 32 queries
  const int nks = (D + 15) / 16;
  const int rows = blockDim.x / 32 * 16;
  const uint32_t sk = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sv = sk + rows * kRowBytes;
  const uint32_t sq = sv + rows * kRowBytes;
  const uint32_t sg = sq + spad * kRowBytes;
  float* smax =
      reinterpret_cast<float*>(smem + (2 * rows + 2 * spad) * kRowBytes);
  float* ssum = smax + spad;
  float* sdel = ssum + spad;
  float* sbias = sdel + spad;              // the tile's keys

  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int j0 = blockIdx.y * rows;
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  const int chunks = D / 8;

  ldot::stage<8>(a.k, base, rs, j0, rows, S - j0, chunks, sk);
  ldot::stage<8>(a.v, base, rs, j0, rows, S - j0, chunks, sv);
  ldot::stage<8>(a.q, base, rs, 0, spad, S, chunks, sq);
  ldot::stage<8>(a.g, base, rs, 0, spad, S, chunks, sg);
  cp_async_commit();
  const size_t n_rows = static_cast<size_t>(gridDim.x) * S;
  const size_t at = static_cast<size_t>(bh) * S;
  for (int i = threadIdx.x; i < spad; i += blockDim.x) {
    const bool ok = i < S;
    smax[i] = ok ? a.stats[at + i] : 0.f;
    ssum[i] = ok ? a.stats[n_rows + at + i] : 1.f;
    sdel[i] = ok ? a.stats[2 * n_rows + at + i] : 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    sbias[r] = j0 + r < S ? a.bias[static_cast<size_t>(b) * S + j0 + r]
                          : -INFINITY;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  if (j0 + wr >= S) return;

  uint32_t ka[kKs][4], va[kKs][4];
#pragma unroll
  for (int ks = 0; ks < kKs; ++ks) {
    if (ks < nks) {
      load_a<8>(ka[ks], sk, wr, ks, lane);
      load_a<8>(va[ks], sv, wr, ks, lane);
    }
  }
  const float kbias[2] = {sbias[wr + g], sbias[wr + g + 8]};
  const uint2 key = a.dropout ? ldot::seed_key(a.seed) : make_uint2(0, 0);
  float dk[kDn][4], dv[kDn][4];
#pragma unroll
  for (int n = 0; n < kDn; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }

  for (int c = 0; c < nch; ++c) {
    // s^T and dp^T: row key g + 8 (e / 2), column query 32 c + 8 n + 2 t
    // + e % 2
    float s[4][4], dpr[4][4];
    chunk_product(s, ka, sq, c, nb, nks, lane);
    chunk_product(dpr, va, sg, c, nb, nks, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int i = 32 * c + 8 * n + 2 * t;
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (a.dropout) ldot::keep_words_kq(w, key, j0 + wr, i, g, h, b);
      if (2 * c + (n >> 1) >= nb) continue;   // past the padded queries
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = i + (e & 1);
        const float sc =
            __fadd_rn(__fmul_rn(s[n][e], a.scale), kbias[e >> 1]);
        const float p = __fdiv_rn(expf(sc - smax[q]), ssum[q]);
        float drop = round_to<Bf16>(p);
        float dp = dpr[n][e];
        if (a.dropout) {
          const bool kept = w[e] < a.thresh;
          drop = kept ? round_to<Bf16>(__fmul_rn(drop, a.mscale)) : 0.f;
          dp = kept ? __fmul_rn(dp, a.mscale_f32) : 0.f;
        }
        s[n][e] = drop;
        dpr[n][e] = round_to<Bf16>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp, sdel[q])), a.scale));
      }
    }
    chunk_times(dv, s, sg, c, nb, nks, lane);
    chunk_times(dk, dpr, sq, c, nb, nks, lane);
  }

  store_rows(a.dv, base, rs, dv, j0 + wr, S, D, g, t);
  store_rows(a.dk, base, rs, dk, j0 + wr, S, D, g, t);
}

template <int NC, int MINB>
cudaError_t launch_dq(const ldot::AttnMmaBwd& a, int batch,
                      cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      bwd_dq_kernel<NC, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem(kMaxRows, kMaxSeq)));
  if (granted != cudaSuccess) return granted;
  const int rows = tile_rows(a.seq);
  const dim3 grid(batch * a.heads, (a.seq + rows - 1) / rows);
  bwd_dq_kernel<NC, MINB>
      <<<grid, rows / 16 * 32, dq_smem(rows, padded(a.seq)), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace ldot {

cudaError_t attention_mma_bwd(const AttnMmaBwd& a, int batch,
                              cudaStream_t stream) {
  if (batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.head_dim <= 0 ||
      a.seq > kMaxSeq || a.head_dim > kMaxHeadDim || a.head_dim % 8 != 0 ||
      !aligned16(a.q) || !aligned16(a.k) || !aligned16(a.v) ||
      !aligned16(a.g) || !aligned16(a.dq) || !aligned16(a.dk) ||
      !aligned16(a.dv))
    return cudaErrorInvalidValue;
  // the dq kernel holds the row in registers up to 128 keys (4 chunks of
  // 32), the 4-chunk form bounded to 3 blocks per SM
  const int nch = (padded(a.seq) / 16 + 1) / 2;
  cudaError_t err = nch > 4    ? launch_dq<0, 1>(a, batch, stream)
                    : nch <= 1 ? launch_dq<1, 1>(a, batch, stream)
                    : nch <= 2 ? launch_dq<2, 1>(a, batch, stream)
                               : launch_dq<4, 3>(a, batch, stream);
  if (err != cudaSuccess) return err;
  static cudaError_t granted_dkv = cudaFuncSetAttribute(
      bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkv_smem(kMaxRows, kMaxSeq)));
  if (granted_dkv != cudaSuccess) return granted_dkv;
  const int rows = tile_rows(a.seq);
  const dim3 grid(batch * a.heads, (a.seq + rows - 1) / rows);
  bwd_dkv_kernel<<<grid, rows / 16 * 32, dkv_smem(rows, padded(a.seq)),
                   stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ldot
