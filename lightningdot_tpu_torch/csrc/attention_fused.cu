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
// in another order); float32 runs on the FMA kernels below, bit-equal to the
// twins:
//   forward:  s = (q.k) * scale + key_bias, float32 softmax e / sum(e),
//             p rounded to T, then p * keep * (1/(1-rate) rounded to T),
//             out = dropped . v accumulated in float32;
//   backward: the forward recomputed; dv = dropped^T . g; dp = (g . v^T) *
//             keep * (1/(1-rate) in float32), left in float32; ds = p * (dp -
//             sum(dp * p)); ds * scale rounded to T before dq = ds . k and
//             dk = ds^T . q.
// The keep mask comes from counter-based Philox4x32-10 (philox.cuh), one
// draw per (batch item, head, row, column), a pure function of its
// coordinates: the forward and both backward kernels, each blocked its own
// way, regenerate the same mask in registers; it never reaches memory. The
// seed is read from device memory, so a layer never waits on the host.
//
// Bound: at the training shapes (B 64, S 32 / 64 / 104, up to 256; H 12,
// D 64) the forward moves 4 B S H D elements and does 4 B H S^2 D flops,
// the backward 7 B S H D elements and 10 B H S^2 D flops (the recomputed
// scores twice): between 10 and 100 flops per byte, so the float32 FMA rate
// bounds these float32 kernels, not the memory. The design is simple rather
// than fast: float32 FMA from shared memory. Each block stages
// one head's K and V (or Q and G) whole and a 32-row tile of the other side
// in shared memory as float32, rows padded by one word where threads of a
// warp walk across rows, and keeps 32 whole rows of scores, so every
// softmax row is reduced in one warp in the twin's order (lane-strided
// partial sums, then a butterfly: ops/attention.py::_warp_order_sum).
//   fwd:  grid (B*H, ceil(S/32) query tiles); 173 KB of shared memory at S
//         256 (float32 only);
//   bwd1: grid (B*H, query tiles): dq, and per row the softmax max and sum
//         and sum(dp * p) for the second kernel; 215 KB at S 256;
//   bwd2: grid (B*H, ceil(S/32) key tiles): dv and dk, recomputing p from
//         the first kernel's row statistics (bit-equal to its own); 218 KB.
#include <cstdint>

#include "attention_mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;        // [B, S] additive key bias
  const long long* seed;    // [1], on the device
  int seq, heads, head_dim;
  float scale;
  float mscale;             // 1 / (1 - rate) rounded to T
  float mscale_f32;         // 1 / (1 - rate) rounded to float32
  unsigned thresh;          // keep iff bits < thresh
  int dropout;              // rate > 0
};

using ldot::keep_draw;
using ldot::seed_key;

// the dropped probability: p rounded to T, then * keep * mscale in T
template <typename T>
__device__ __forceinline__ float dropped(const Args& a, float p, uint2 key,
                                         int b, int h, int i, int j) {
  const float pc = ldot::round_to<T>(p);
  if (!a.dropout) return pc;
  return keep_draw(key, b, h, i, j, a.thresh)
             ? ldot::round_to<T>(__fmul_rn(pc, a.mscale))
             : 0.f;
}

// (g . v^T) * keep * mscale, left in float32
__device__ __forceinline__ float dprob(const Args& a, float ddrop, uint2 key,
                                       int b, int h, int i, int j) {
  if (!a.dropout) return ddrop;
  return keep_draw(key, b, h, i, j, a.thresh) ? __fmul_rn(ddrop, a.mscale_f32)
                                              : 0.f;
}

__device__ __forceinline__ float score(const float* x, const float* y, int D,
                                       float scale, float bias) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return __fadd_rn(__fmul_rn(acc, scale), bias);
}

__device__ __forceinline__ float dot(const float* x, const float* y, int D) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(x[d], y[d], acc);
  return acc;
}

// one head's rows [0, n) of x ([B, S, H*D]) into s[r * stride + d]
template <typename T>
__device__ __forceinline__ void stage(const T* x, size_t base, size_t rs,
                                      int r0, int n, int D, float* s,
                                      int stride) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    s[r * stride + d] = ldot::to_f32(x[base + (r0 + r) * rs + d]);
  }
}

// softmax of a row of scores in place: max, e = exp(s - max), the sum in
// warp order, p = e / sum. Returns (max, sum) to every lane.
__device__ __forceinline__ float2 softmax_row(float* row, int S, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
  m = ldot::warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < S; j += 32) {
    const float e = expf(row[j] - m);
    row[j] = e;
    sum += e;
  }
  sum = ldot::warp_sum(sum);
  for (int j = lane; j < S; j += 32) row[j] = row[j] / sum;
  return make_float2(m, sum);
}

size_t fwd_floats(int S, int D) {
  // k [S][D+1], v [S][D], q [T][D], p [T][S+1]
  return static_cast<size_t>(S) * (2 * D + 1) + kTile * D +
         static_cast<size_t>(kTile) * (S + 1);
}

size_t bwd_q_floats(int S, int D) {
  // k, v [S][D+1]; q, g [T][D]; p, ds [T][S+1]
  return static_cast<size_t>(S) * 2 * (D + 1) + 2 * kTile * D +
         static_cast<size_t>(2) * kTile * (S + 1);
}

size_t bwd_kv_floats(int S, int D) {
  // q, g [S][D+1]; k, v [T][D]; p^T, x^T [T][S+1]; max, sum, delta [S]
  return bwd_q_floats(S, D) + static_cast<size_t>(3) * S;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(Args a, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int S = a.seq, D = a.head_dim, kd = D + 1, ps = S + 1;
  float* sk = smem;
  float* sv = sk + S * kd;
  float* sq = sv + S * D;
  float* sp = sq + kTile * D;

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int i0 = blockIdx.y * kTile;
  const int nq = min(kTile, S - i0);
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  stage(static_cast<const T*>(a.k), base, rs, 0, S, D, sk, kd);
  stage(static_cast<const T*>(a.v), base, rs, 0, S, D, sv, D);
  stage(static_cast<const T*>(a.q), base, rs, i0, nq, D, sq, D);
  __syncthreads();

  const float* brow = a.bias + static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < nq * S; idx += kThreads) {
    const int i = idx / S;
    const int j = idx - i * S;
    sp[i * ps + j] = score(sq + i * D, sk + j * kd, D, a.scale, brow[j]);
  }
  __syncthreads();

  const uint2 key = seed_key(a.seed);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < nq; i += kWarps) {
    float* row = sp + i * ps;
    softmax_row(row, S, lane);
    for (int j = lane; j < S; j += 32)
      row[j] = dropped<T>(a, row[j], key, b, h, i0 + i, j);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const float* pi = sp + i * ps;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(pi[j], sv[j * D + d], acc);
    out[base + (i0 + i) * rs + d] = ldot::from_f32<T>(acc);
  }
}

// dq for a tile of query rows, and per row: softmax max, sum, sum(dp * p)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_q_kernel(Args a, const T* __restrict__ g, T* __restrict__ dq,
                 float* __restrict__ stats) {
  extern __shared__ float smem[];
  const int S = a.seq, D = a.head_dim, kd = D + 1, ps = S + 1;
  float* sk = smem;
  float* sv = sk + S * kd;
  float* sq = sv + S * kd;
  float* sg = sq + kTile * D;
  float* sp = sg + kTile * D;
  float* sd = sp + kTile * ps;

  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int i0 = blockIdx.y * kTile;
  const int nq = min(kTile, S - i0);
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  stage(static_cast<const T*>(a.k), base, rs, 0, S, D, sk, kd);
  stage(static_cast<const T*>(a.v), base, rs, 0, S, D, sv, kd);
  stage(static_cast<const T*>(a.q), base, rs, i0, nq, D, sq, D);
  stage(g, base, rs, i0, nq, D, sg, D);
  __syncthreads();

  const float* brow = a.bias + static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < nq * S; idx += kThreads) {
    const int i = idx / S;
    const int j = idx - i * S;
    sp[i * ps + j] = score(sq + i * D, sk + j * kd, D, a.scale, brow[j]);
    sd[i * ps + j] = dot(sg + i * D, sv + j * kd, D);     // g . v^T
  }
  __syncthreads();

  const size_t n_rows = static_cast<size_t>(gridDim.x) * S;
  const size_t at = static_cast<size_t>(bh) * S + i0;
  const uint2 key = seed_key(a.seed);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < nq; i += kWarps) {
    float* prow = sp + i * ps;
    float* drow = sd + i * ps;
    const float2 ms = softmax_row(prow, S, lane);
    float part = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float dp = dprob(a, drow[j], key, b, h, i0 + i, j);
      drow[j] = dp;
      part = __fadd_rn(part, __fmul_rn(dp, prow[j]));
    }
    const float delta = ldot::warp_sum(part);
    for (int j = lane; j < S; j += 32) {
      const float ds = __fmul_rn(prow[j], __fsub_rn(drow[j], delta));
      drow[j] = ldot::round_to<T>(__fmul_rn(ds, a.scale));
    }
    if (lane == 0) {
      stats[at + i] = ms.x;
      stats[n_rows + at + i] = ms.y;
      stats[2 * n_rows + at + i] = delta;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const float* di = sd + i * ps;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(di[j], sk[j * kd + d], acc);
    dq[base + (i0 + i) * rs + d] = ldot::from_f32<T>(acc);
  }
}

// dv and dk for a tile of key columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kv_kernel(Args a, const T* __restrict__ g, T* __restrict__ dk,
                  T* __restrict__ dv, const float* __restrict__ stats) {
  extern __shared__ float smem[];
  const int S = a.seq, D = a.head_dim, kd = D + 1, ps = S + 1;
  float* sq = smem;
  float* sg = sq + S * kd;
  float* sk = sg + S * kd;
  float* sv = sk + kTile * D;
  float* sp = sv + kTile * D;       // p^T [key][query]
  float* sx = sp + kTile * ps;      // dropped^T, then ds^T
  float* sm = sx + kTile * ps;
  float* sl = sm + S;
  float* sdel = sl + S;

  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int j0 = blockIdx.y * kTile;
  const int nk = min(kTile, S - j0);
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  stage(static_cast<const T*>(a.q), base, rs, 0, S, D, sq, kd);
  stage(g, base, rs, 0, S, D, sg, kd);
  stage(static_cast<const T*>(a.k), base, rs, j0, nk, D, sk, D);
  stage(static_cast<const T*>(a.v), base, rs, j0, nk, D, sv, D);
  const size_t n_rows = static_cast<size_t>(gridDim.x) * S;
  const size_t at = static_cast<size_t>(bh) * S;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    sm[i] = stats[at + i];
    sl[i] = stats[n_rows + at + i];
    sdel[i] = stats[2 * n_rows + at + i];
  }
  __syncthreads();

  // p (bit-equal to the first kernel's: the same score, max and sum) and
  // the dropped probabilities, transposed
  const uint2 key = seed_key(a.seed);
  const float* brow = a.bias + static_cast<size_t>(b) * S + j0;
  for (int idx = threadIdx.x; idx < nk * S; idx += kThreads) {
    const int j = idx / S;
    const int i = idx - j * S;
    const float s = score(sq + i * kd, sk + j * D, D, a.scale, brow[j]);
    const float p = expf(s - sm[i]) / sl[i];
    sp[j * ps + i] = p;
    sx[j * ps + i] = dropped<T>(a, p, key, b, h, i, j0 + j);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx - j * D;
    const float* xj = sx + j * ps;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(xj[i], sg[i * kd + d], acc);
    dv[base + (j0 + j) * rs + d] = ldot::from_f32<T>(acc);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nk * S; idx += kThreads) {
    const int j = idx / S;
    const int i = idx - j * S;
    const float dp = dprob(a, dot(sg + i * kd, sv + j * D, D), key, b, h, i,
                           j0 + j);
    const float ds = __fmul_rn(sp[j * ps + i], __fsub_rn(dp, sdel[i]));
    sx[j * ps + i] = ldot::round_to<T>(__fmul_rn(ds, a.scale));
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nk * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx - j * D;
    const float* xj = sx + j * ps;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(xj[i], sq[i * kd + d], acc);
    dk[base + (j0 + j) * rs + d] = ldot::from_f32<T>(acc);
  }
}

// above 48 KB a block's shared memory must be granted explicitly; grant
// the largest supported shape once per kernel
template <typename K>
cudaError_t grant(K kernel, size_t floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(floats * sizeof(float)));
}

template <typename T>
cudaError_t launch_fwd(const Args& a, int batch, void* out,
                       cudaStream_t stream) {
  static cudaError_t granted =
      grant(fwd_kernel<T>, fwd_floats(kMaxSeq, kMaxHeadDim));
  if (granted != cudaSuccess) return granted;
  const dim3 grid(batch * a.heads, (a.seq + kTile - 1) / kTile);
  fwd_kernel<T><<<grid, kThreads, fwd_floats(a.seq, a.head_dim) *
                                      sizeof(float), stream>>>(
      a, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const Args& a, int batch, const void* g, void* dq,
                       void* dk, void* dv, float* stats,
                       cudaStream_t stream) {
  static cudaError_t granted_q =
      grant(bwd_q_kernel<T>, bwd_q_floats(kMaxSeq, kMaxHeadDim));
  static cudaError_t granted_kv =
      grant(bwd_kv_kernel<T>, bwd_kv_floats(kMaxSeq, kMaxHeadDim));
  if (granted_q != cudaSuccess) return granted_q;
  if (granted_kv != cudaSuccess) return granted_kv;
  const dim3 grid(batch * a.heads, (a.seq + kTile - 1) / kTile);
  bwd_q_kernel<T><<<grid, kThreads,
                    bwd_q_floats(a.seq, a.head_dim) * sizeof(float),
                    stream>>>(a, static_cast<const T*>(g),
                              static_cast<T*>(dq), stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<T><<<grid, kThreads,
                     bwd_kv_floats(a.seq, a.head_dim) * sizeof(float),
                     stream>>>(a, static_cast<const T*>(g),
                               static_cast<T*>(dk), static_cast<T*>(dv),
                               stats);
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
  const Args a{q, k, v, bias, seed, seq, heads, head_dim, scale, mscale,
               0.f, thresh, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32) return launch_fwd<float>(a, batch, out, s);
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
  const Args a{q, k, v, bias, seed, seq, heads, head_dim, scale, mscale,
               mscale_f32, thresh, dropout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return launch_bwd<float>(a, batch, g, dq, dk, dv, stats, s);
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
