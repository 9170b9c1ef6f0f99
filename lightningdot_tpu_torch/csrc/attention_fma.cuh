// Float32 attention on the FMA units, register-blocked: the building blocks
// shared by the attention kernel (attention.cu, which also runs the
// training attention's float32 forward with a dropout pass) and the
// training attention's float32 backward (attention_fused.cu).
//
// The kernels are bit-equal to their plain twins (ops/attention.py::
// _attention_math, ops/attention_fused.py::_fused_attn_{fwd,bwd}_math on
// the card: cuBLAS float32 products with TF32 off, sums in torch's warp
// order). Register blocking changes which thread computes a sum, never the
// order of one:
//   - each element of a product X Y^T (a score, g . v^T) is one sequential
//     FMA chain over d = 0 .. D-1 (score_phase), then for a score * scale
//     and + bias, each rounded (no contraction);
//   - each element of a product P^T V (p . v, ds . k, dropped^T . g, ds^T
//     . q) is one sequential FMA chain over its reduction index in
//     ascending order (pv_phase);
//   - a row sum is taken as torch's warp softmax takes it: lane l of 32 adds
//     elements l, l + 32, ... in turn, then the 32 partials meet in a
//     butterfly (16, 8, 4, 2, 1). Here R threads share a row (R = 4 or 8),
//     thread c holding the partials of lanes c, c + R, ..., c + 32 - R: the
//     butterfly's levels at offsets >= R are additions inside the thread,
//     the others shuffles among the R (warp_order_sum).
//
// Layouts: an operand is staged as [rows][ld] floats with ld = round4(D) +
// 4, the padding putting the rows a warp reads at once in distinct banks;
// a product tile is [n][kLd] with the tile's own rows (queries, or the keys
// of the transposed products) on the minor axis.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace ldot {

// out = softmax(q k^T * scale + key_bias) v in float32 (attention.cu), for
// q, k, v, out [B, S, H, D] (= [B, S, H*D]) contiguous, S <= 256, D <= 64.
// defer = 1 divides by the row sum after e . v (ops/attention.py's
// deferred path); dropout = 1 (the training forward, defer 0) keeps the
// normalized p iff its Philox word < thresh (philox.cuh) and multiplies the
// kept by mscale, before p . v. Returns cudaErrorInvalidValue on a bad
// shape.
struct AttnFma {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;        // [B, S] additive key bias
  float* out;
  int seq, heads, head_dim;
  float scale;
  int defer;
  const long long* seed;    // one int64 on the device; read iff dropout
  float mscale;             // 1 / (1 - rate) rounded to float32
  unsigned thresh;
  int dropout;
};

cudaError_t attention_fma(const AttnFma& a, int batch, cudaStream_t stream);

namespace fma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

// the row stride of a staged operand, floats
__host__ __device__ constexpr int operand_ld(int head_dim) {
  return round4(head_dim) + 4;
}

// rows [r0, r0 + n) of one head of x ([B, S, H*D]: the head's first row at
// base, rows rs apart) into s[r * ld + d] for r < rows, zeros past n and
// past D. vec (D % 4 == 0, x 16-byte aligned): by cp.async, which the
// caller commits and waits for; else by plain loads. The rows past n are
// a loop of their own: one loop over all rows with a per-row select was
// 2-3 % slower for the attention kernel at [640, 167] (and 4-5 % faster
// for the training backward at S 32-64; H100 80GB HBM3 at 700 W).
__device__ __forceinline__ void stage(const float* x, size_t base,
                                      size_t rs, int r0, int n, int rows,
                                      int D, int ld, float* s, bool vec) {
  if (vec) {
    const int c4 = D / 4;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(s));
    for (int idx = threadIdx.x; idx < n * c4; idx += kThreads) {
      const int r = idx / c4, c = idx % c4;
      cp_async16(dst + (r * ld + c * 4) * 4, x + base + (r0 + r) * rs + c * 4,
                 true);
    }
    for (int idx = n * c4 + threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int r = idx / c4, c = idx % c4;
      cp_async16(dst + (r * ld + c * 4) * 4, x, false);
    }
  } else {
    const int D4 = round4(D);
    for (int idx = threadIdx.x; idx < rows * D4; idx += kThreads) {
      const int r = idx / D4, d = idx % D4;
      s[r * ld + d] = r < n && d < D ? x[base + (r0 + r) * rs + d] : 0.f;
    }
  }
}

// the epilogue of a product element: none; * scale + the bias of its
// column (the key, in Q K^T); * scale + the bias of its row (the key, in
// K Q^T)
enum Epilogue : int { kRaw = 0, kBiasCol = 1, kBiasRow = 2 };

// one 16-row x 32-column chunk of X Y^T with NY columns a thread (NY < 4
// only in a last, partial chunk): the thread takes rows xb + {0, 4, 8, 12}
// and columns yb + {0, 8, 16, 24}, and per 4 values of d, four 128-bit
// loads of X and NY of Y feed 16 NY FMAs. Writes pp[column * kLd + 4 x]
// (pp = P + xb) for the columns below ny; bias is the row's keys (kBiasCol:
// the columns', kBiasRow: the rows', those at or past nx read as 0).
template <int NY, int kLd, int kEpi>
__device__ __forceinline__ void score_chunk(const float* xp, const float* yp,
                                            int ld, int d4, float scale,
                                            const float* bias, int xb,
                                            int nx, int yb, int ny,
                                            float* pp) {
  float acc[4][NY];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
#pragma unroll
    for (int y = 0; y < NY; ++y) acc[x][y] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 xv[4], yv[NY];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      xv[x] = *reinterpret_cast<const float4*>(xp + 4 * x * ld + d);
#pragma unroll
    for (int y = 0; y < NY; ++y)
      yv[y] = *reinterpret_cast<const float4*>(yp + 8 * y * ld + d);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
#pragma unroll
      for (int y = 0; y < NY; ++y) {
        acc[x][y] = fmaf(xv[x].x, yv[y].x, acc[x][y]);
        acc[x][y] = fmaf(xv[x].y, yv[y].y, acc[x][y]);
        acc[x][y] = fmaf(xv[x].z, yv[y].z, acc[x][y]);
        acc[x][y] = fmaf(xv[x].w, yv[y].w, acc[x][y]);
      }
    }
  }
  float bx[4];
#pragma unroll
  for (int x = 0; x < 4; ++x)
    bx[x] = kEpi == kBiasRow && xb + 4 * x < nx ? bias[xb + 4 * x] : 0.f;
#pragma unroll
  for (int y = 0; y < NY; ++y) {
    const int j = yb + 8 * y;
    if (j >= ny) break;
    const float bj = kEpi == kBiasCol ? bias[j] : 0.f;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float s = acc[x][y];
      if (kEpi == kBiasCol) s = __fadd_rn(__fmul_rn(s, scale), bj);
      if (kEpi == kBiasRow) s = __fadd_rn(__fmul_rn(s, scale), bx[x]);
      pp[j * kLd + 4 * x] = s;
    }
  }
}

// P[j][i] = X_i . Y_j (then the epilogue) for the nx rows of X and ny rows
// of Y, a warp taking a 16 x 32 chunk at a time. X is staged to
// round16(nx) rows; Y's region must hold round8(ny) rows (a partial chunk's
// loads reach that far and are not stored).
template <int kLd, int kEpi>
__device__ __forceinline__ void score_phase(const float* X, int nx,
                                            const float* Y, int ny, int ld,
                                            int d4, float scale,
                                            const float* bias, float* P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ql = lane & 3, kl = lane >> 2;
  const int cq = (nx + 15) / 16;
  const int chunks = cq * ((ny + 31) / 32);
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int xb = (ch % cq) * 16 + ql;
    const int yb0 = (ch / cq) * 32;
    const int yb = yb0 + kl;
    const float* xp = X + xb * ld;
    const float* yp = Y + yb * ld;
    float* pp = P + xb;
    const int n = min(4, (ny - yb0 + 7) / 8);   // columns a thread, uniform
    if (n == 4)
      score_chunk<4, kLd, kEpi>(xp, yp, ld, d4, scale, bias, xb, nx, yb, ny,
                                pp);
    else if (n == 3)
      score_chunk<3, kLd, kEpi>(xp, yp, ld, d4, scale, bias, xb, nx, yb, ny,
                                pp);
    else if (n == 2)
      score_chunk<2, kLd, kEpi>(xp, yp, ld, d4, scale, bias, xb, nx, yb, ny,
                                pp);
    else
      score_chunk<1, kLd, kEpi>(xp, yp, ld, d4, scale, bias, xb, nx, yb, ny,
                                pp);
  }
}

// the row sum of torch's warp reduction from one thread's partials (lanes
// c, c + R, ...), R threads a row
template <int R>
__device__ __forceinline__ float warp_order_sum(float (&part)[32 / R]) {
#pragma unroll
  for (int h = 16 / R; h > 0; h >>= 1) {
#pragma unroll
    for (int u = 0; u < h; ++u) part[u] = __fadd_rn(part[u], part[u + h]);
  }
  float s = part[0];
#pragma unroll
  for (int off = R / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// a row of a product tile (col = P + row, elements kLd apart): its max, e =
// exp(s - max) written in place, and the sum of the e in the warp's order,
// R threads a row (c = the thread's place in it). A row past the tile
// passes js = 0: it runs no element but takes part in the shuffles.
// Returns (max, sum) to the R threads.
template <int R, int kLd>
__device__ __forceinline__ float2 softmax_exp(float* col, int js, int c) {
  float m = -INFINITY;
  for (int j = c; j < js; j += R) m = fmaxf(m, col[j * kLd]);
#pragma unroll
  for (int off = R / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float part[32 / R];
#pragma unroll
  for (int u = 0; u < 32 / R; ++u) part[u] = 0.f;
  for (int j0 = 0; j0 < js; j0 += 32) {
#pragma unroll
    for (int u = 0; u < 32 / R; ++u) {
      const int j = j0 + c + R * u;
      if (j < js) {
        const float e = expf(col[j * kLd] - m);
        col[j * kLd] = e;
        part[u] = __fadd_rn(part[u], e);
      }
    }
  }
  return make_float2(m, warp_order_sum<R>(part));
}

// the four keep words of keys 4 g .. 4 g + 3 of query row i (one Philox
// draw: counter (g, i, h, b))
__device__ __forceinline__ void keep_words(unsigned (&w)[4], uint2 key,
                                           int g, int i, int h, int b) {
  const uint4 r = philox4x32_10(make_uint4(g, i, h, b), key);
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}

// whether elements 4 g .. 4 g + 3 (those below js) of a product tile's
// row (col = P + row, elements kLd apart) are all 0
template <int kLd>
__device__ __forceinline__ bool all_zero(const float* col, int g, int js) {
  bool zero = true;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = 4 * g + u;
    zero = zero && (j >= js || col[j * kLd] == 0.f);
  }
  return zero;
}

// out[i][d] = sum over j = 0 .. n-1 of P[j][i] V[j][d], in that order, for
// i < nx and d < D4 (V rows ldv apart), written to out + i * rs + d for d <
// D (vec: 128-bit stores), each divided by div[i] where div is given: a
// warp takes 4 row groups x 8 column quads at a time, a thread an NX x 4
// microtile; per j, NX / 4 128-bit loads of P and one of V feed 4 NX FMAs.
template <int kLd, int NX>
__device__ __forceinline__ void pv_phase(const float* P, const float* V,
                                         int ldv, int n, int nx, int D4,
                                         float* out, size_t rs, int D,
                                         bool vec, const float* div) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ndq = D4 / 4;
  const int no = (nx + NX - 1) / NX;
  const int co = (no + 3) / 4;
  const int chunks = co * ((ndq + 7) / 8);
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int qo = (ch % co) * 4 + (lane & 3);
    const int dq = (ch / co) * 8 + (lane >> 2);
    if (qo >= no || dq >= ndq) continue;
    float acc[NX][4];
#pragma unroll
    for (int x = 0; x < NX; ++x) {
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[x][y] = 0.f;
    }
    const float* pp = P + qo * NX;
    const float* vp = V + dq * 4;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float pa[NX];
#pragma unroll
      for (int x4 = 0; x4 < NX / 4; ++x4) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pp + j * kLd + 4 * x4);
        pa[4 * x4] = p4.x;
        pa[4 * x4 + 1] = p4.y;
        pa[4 * x4 + 2] = p4.z;
        pa[4 * x4 + 3] = p4.w;
      }
      const float4 vv = *reinterpret_cast<const float4*>(vp + j * ldv);
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int x = 0; x < NX; ++x) {
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(pa[x], va[y], acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const int i = qo * NX + x;
      if (i >= nx) break;
      float o[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) o[y] = div ? acc[x][y] / div[i] : acc[x][y];
      float* dst = out + i * rs + dq * 4;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int y = 0; y < 4; ++y)
          if (dq * 4 + y < D) dst[y] = o[y];
      }
    }
  }
}

}  // namespace fma
}  // namespace ldot
