// Multi-head latent attention's attention core (DeepSeek-V3, arXiv
// 2412.19437; the Moonlight text tower, models/moonlight.py), forward and
// backward:
//
//   s = q k^T * scale, over the keys j that are real (key_ok) and, when
//       causal, j <= i; p = softmax(s); o = p v; lse = log sum exp(s)
//
// for each real query i; a query that is not a real token (key_ok 0:
// padding) reads nothing: its o is 0, its lse +inf, and its gradients 0,
// so that the work follows the real tokens, not the padded length
//
// with q, k [B, S, heads, dqk] (dqk 192: 128 without RoPE and 64 with it,
// the RoPE part of k one head's, broadcast by the caller) and v
// [B, S, heads, dv] (dv 128): the query/key width and the value width
// differ, which csrc/attention*.cu (head dim <= 64, one width, no causal
// mask) do not take.
//
// Replaces no TPU kernel: the JAX package's towers are BERT's. Bound: at
// the text tower's S = 32-64 the work is tiny (4 B S^2 heads (dqk + dv)
// operations, 2.7 GFLOP a layer at batch 512 and S = 32) and every
// operand is read once (q, k, v: 150 MB a layer in bf16), so device memory
// bounds it, at about 45 us a layer forward at 3.35 TB/s.
//
// Design: one block of 4 warps per (sequence, head). The head's k and v
// rows are staged in shared memory as float32 (rows padded by one float,
// so that 32 lanes reading 32 keys' element d hit 32 banks); a warp takes
// a query row at a time: lane j scores key j (FMA over dqk, the query row
// broadcast from shared memory), the row's max and sum meet in warp
// shuffles, then lane d sums p_j v_jd. The backward stages k and v, and a
// warp per query row writes p and ds = p (dp - D) to shared memory
// (S x S float32 each) and dq; after a barrier the q and dO rows replace
// k and v in shared memory and a warp per key row sums dk and dv. Every
// sum is one thread's or one warp's in a fixed order: no atomics, and a
// launch repeats its bits. Float32 arithmetic throughout, on FMA units:
// at these sizes the tensor cores would wait on the loads. Padding's rows
// are neither staged nor scored. S <= 64 (the text rungs of the tower's
// captions); a longer sequence raises in the wrapper
// (ops/mla_attention.py).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeq = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxSmem = 200 * 1024;

using ldot::from_f32;
using ldot::to_f32;

__device__ __forceinline__ bool allowed(const float* key_ok, int b, int S,
                                        int i, int j, int causal) {
  return j < S && (!causal || j <= i) && key_ok[b * S + j] > 0.f;
}

// rows j of x's head h into dst [S][D + 1] as float32; padding's rows
// (key_ok 0) are not read and staged as 0, so that a 0 weight on them
// never meets stale shared memory
template <typename T>
__device__ __forceinline__ void stage_rows(const T* x, const float* key_ok,
                                           int b, int h, int S, int NH, int D,
                                           float* dst) {
  for (int idx = threadIdx.x; idx < S * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    dst[j * (D + 1) + d] =
        key_ok[b * S + j] > 0.f
            ? to_f32(x[(static_cast<size_t>(b) * S + j) * NH * D +
                       static_cast<size_t>(h) * D + d])
            : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ key_ok,
                   T* __restrict__ o, float* __restrict__ lse, int S, int NH,
                   int DQK, int DV, float scale, int causal) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / NH, h = blockIdx.x % NH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = sm;                          // [S][DQK + 1]
  float* vs = ks + S * (DQK + 1);          // [S][DV + 1]
  float* qw = vs + S * (DV + 1) + warp * (DQK + S);   // [DQK]
  float* pw = qw + DQK;                                // [S]
  stage_rows(k, key_ok, b, h, S, NH, DQK, ks);
  stage_rows(v, key_ok, b, h, S, NH, DV, vs);
  __syncthreads();
  for (int i = warp; i < S; i += kWarps) {
    const size_t row = (static_cast<size_t>(b) * S + i) * NH + h;
    if (key_ok[b * S + i] <= 0.f) {       // padding reads nothing
      for (int d = lane; d < DV; d += 32) o[row * DV + d] = from_f32<T>(0.f);
      if (lane == 0) lse[(static_cast<size_t>(b) * NH + h) * S + i] =
          INFINITY;
      continue;
    }
    for (int d = lane; d < DQK; d += 32) qw[d] = to_f32(q[row * DQK + d]);
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      float s = -INFINITY;
      if (allowed(key_ok, b, S, i, j, causal)) {
        const float* kr = ks + j * (DQK + 1);
        float dot = 0.f;
        for (int d = 0; d < DQK; ++d) dot += qw[d] * kr[d];
        s = dot * scale;
      }
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = ldot::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = pw[j] == -INFINITY ? 0.f : expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = ldot::warp_sum(sum);
    __syncwarp();
    const float inv = sum > 0.f ? 1.0f / sum : 0.f;
    const int jn = causal ? min(i + 1, S) : S;
    for (int d = lane; d < DV; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < jn; ++j) acc += pw[j] * vs[j * (DV + 1) + d];
      o[row * DV + d] = from_f32<T>(acc * inv);
    }
    if (lane == 0) lse[(static_cast<size_t>(b) * NH + h) * S + i] =
        sum > 0.f ? mx + logf(sum) : INFINITY;
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ g, const float* __restrict__ key_ok,
                   const float* __restrict__ lse, T* __restrict__ dq,
                   T* __restrict__ dk, T* __restrict__ dv, int S, int NH,
                   int DQK, int DV, float scale, int causal) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / NH, h = blockIdx.x % NH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = sm;                          // [S][DQK + 1], then q
  float* vs = ks + S * (DQK + 1);          // [S][DV + 1], then dO
  float* P = vs + S * (DV + 1);            // [S][S + 1]
  float* dS = P + S * (S + 1);             // [S][S + 1]
  float* qw = dS + S * (S + 1) + warp * (DQK + DV);   // [DQK]
  float* gw = qw + DQK;                                // [DV]
  stage_rows(k, key_ok, b, h, S, NH, DQK, ks);
  stage_rows(v, key_ok, b, h, S, NH, DV, vs);
  __syncthreads();
  for (int i = warp; i < S; i += kWarps) {
    const size_t row = (static_cast<size_t>(b) * S + i) * NH + h;
    if (key_ok[b * S + i] <= 0.f) {       // padding: p, ds and dq are 0
      for (int j = lane; j < S; j += 32)
        P[i * (S + 1) + j] = dS[i * (S + 1) + j] = 0.f;
      for (int d = lane; d < DQK; d += 32)
        dq[row * DQK + d] = from_f32<T>(0.f);
      continue;
    }
    float di = 0.f;
    for (int d = lane; d < DQK; d += 32) qw[d] = to_f32(q[row * DQK + d]);
    for (int d = lane; d < DV; d += 32) {
      const float gd = to_f32(g[row * DV + d]);
      gw[d] = gd;
      di += gd * to_f32(o[row * DV + d]);
    }
    di = ldot::warp_sum(di);
    __syncwarp();
    const float L = lse[(static_cast<size_t>(b) * NH + h) * S + i];
    for (int j = lane; j < S; j += 32) {
      float p = 0.f, ds = 0.f;
      if (allowed(key_ok, b, S, i, j, causal)) {
        const float* kr = ks + j * (DQK + 1);
        const float* vr = vs + j * (DV + 1);
        float dot = 0.f, dp = 0.f;
        for (int d = 0; d < DQK; ++d) dot += qw[d] * kr[d];
        for (int d = 0; d < DV; ++d) dp += gw[d] * vr[d];
        p = expf(dot * scale - L);
        ds = p * (dp - di);
      }
      P[i * (S + 1) + j] = p;
      dS[i * (S + 1) + j] = ds;
    }
    __syncwarp();
    for (int d = lane; d < DQK; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < S; ++j)
        acc += dS[i * (S + 1) + j] * ks[j * (DQK + 1) + d];
      dq[row * DQK + d] = from_f32<T>(acc * scale);
    }
    __syncwarp();
  }
  __syncthreads();
  stage_rows(q, key_ok, b, h, S, NH, DQK, ks);
  stage_rows(g, key_ok, b, h, S, NH, DV, vs);
  __syncthreads();
  for (int j = warp; j < S; j += kWarps) {
    const size_t row = (static_cast<size_t>(b) * S + j) * NH + h;
    if (key_ok[b * S + j] <= 0.f) {       // a padding key: no gradient
      for (int d = lane; d < DV; d += 32) dv[row * DV + d] = from_f32<T>(0.f);
      for (int d = lane; d < DQK; d += 32)
        dk[row * DQK + d] = from_f32<T>(0.f);
      continue;
    }
    const int i0 = causal ? j : 0;
    for (int d = lane; d < DV; d += 32) {
      float acc = 0.f;
      for (int i = i0; i < S; ++i)
        acc += P[i * (S + 1) + j] * vs[i * (DV + 1) + d];
      dv[row * DV + d] = from_f32<T>(acc);
    }
    for (int d = lane; d < DQK; d += 32) {
      float acc = 0.f;
      for (int i = i0; i < S; ++i)
        acc += dS[i * (S + 1) + j] * ks[i * (DQK + 1) + d];
      dk[row * DQK + d] = from_f32<T>(acc * scale);
    }
  }
}

int fwd_smem(int S, int DQK, int DV) {
  return 4 * (S * (DQK + 1) + S * (DV + 1) + kWarps * (DQK + S));
}

int bwd_smem(int S, int DQK, int DV) {
  return 4 * (S * (DQK + 1) + S * (DV + 1) + 2 * S * (S + 1) +
              kWarps * (DQK + DV));
}

bool shape_ok(int B, int S, int NH, int DQK, int DV) {
  return B > 0 && S > 0 && S <= kMaxSeq && NH > 0 && DQK > 0 &&
         DQK <= kMaxDim && DV > 0 && DV <= kMaxDim;
}

template <typename T>
cudaError_t forward(const void* q, const void* k, const void* v,
                    const float* key_ok, void* o, float* lse, int B, int S,
                    int NH, int DQK, int DV, float scale, int causal,
                    cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      mla_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (granted != cudaSuccess) return granted;
  mla_fwd_kernel<T><<<B * NH, kThreads, fwd_smem(S, DQK, DV), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_ok, static_cast<T*>(o), lse, S, NH, DQK,
      DV, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* o, const void* g, const float* key_ok,
                     const float* lse, void* dq, void* dk, void* dv, int B,
                     int S, int NH, int DQK, int DV, float scale, int causal,
                     cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      mla_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (granted != cudaSuccess) return granted;
  mla_bwd_kernel<T><<<B * NH, kThreads, bwd_smem(S, DQK, DV), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(g), key_ok, lse, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), S, NH, DQK, DV, scale,
      causal);
  return cudaGetLastError();
}

}  // namespace

// q, k: [B, S, NH, DQK]; v, o: [B, S, NH, DV], contiguous, float32 or
// bfloat16 (dtype code); key_ok: float32 [B, S] (> 0: a real key); lse:
// float32 [B, NH, S]. S <= 64, DQK and DV <= 256.
extern "C" int ldot_mla_attention(const void* q, const void* k,
                                  const void* v, const float* key_ok,
                                  void* o, float* lse, int B, int S, int NH,
                                  int DQK, int DV, float scale, int causal,
                                  int dtype, void* stream) {
  if (!shape_ok(B, S, NH, DQK, DV) || fwd_smem(S, DQK, DV) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return forward<float>(q, k, v, key_ok, o, lse, B, S, NH, DQK, DV, scale,
                          causal, s);
  if (dtype == ldot::kBFloat16)
    return forward<__nv_bfloat16>(q, k, v, key_ok, o, lse, B, S, NH, DQK, DV,
                                  scale, causal, s);
  return cudaErrorInvalidValue;
}

// The backward of ldot_mla_attention at cotangent g (o's shape and dtype):
// dq, dk (q's shape), dv (v's), from the forward's o and lse.
extern "C" int ldot_mla_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* g, const float* key_ok,
                                      const float* lse, void* dq, void* dk,
                                      void* dv, int B, int S, int NH,
                                      int DQK, int DV, float scale,
                                      int causal, int dtype, void* stream) {
  if (!shape_ok(B, S, NH, DQK, DV) || bwd_smem(S, DQK, DV) > kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return backward<float>(q, k, v, o, g, key_ok, lse, dq, dk, dv, B, S, NH,
                           DQK, DV, scale, causal, s);
  if (dtype == ldot::kBFloat16)
    return backward<__nv_bfloat16>(q, k, v, o, g, key_ok, lse, dq, dk, dv, B,
                                   S, NH, DQK, DV, scale, causal, s);
  return cudaErrorInvalidValue;
}
