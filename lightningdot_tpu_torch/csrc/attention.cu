// Self-attention for sequences up to 256 in float32, one block per (batch,
// head, tile of 32 queries): out = softmax(q k^T * scale + key_bias) v. The
// bfloat16 forms go to the tensor-core kernel (attention_mma.cu); the C
// entry below splits by dtype.
//
// Replaces the TPU kernel lightningdot_tpu/ops/attention.py::_attn_kernel
// (launched by _attention_pallas) in float32. The TPU kernel needed a
// head-major [B,H,S,D] copy of q, k and v; this kernel reads them straight
// out of the projection-native [B,S,H,D] layout by strides and writes the
// output in that layout, so no transpose ever touches device memory.
//
// Scores, softmax and probs @ v run in float32. Two numeric paths mirror
// ops/attention.py::_attention_math:
//   defer = 0: normalized probabilities, rounded to the input dtype before
//              probs @ v (a no-op rounding in float32);
//   defer = 1: un-normalized exp(s - max), the float32 row sum kept aside,
//              and the division applied after probs @ v.
// A tile holds whole score rows, so every row is summed in the same order
// whatever the tiling: the kernel is bit-equal to its twin, which is what
// the float32 checks on the card hold it to. The configurations that serve,
// encode and train are bfloat16, so this path is kept right, not fast.
//
// Bound: at the path's shapes (S <= 256, D = 64) a block moves its head's K
// and V and a tile of q and out, and does 4*32*S*D float32 FMA flops. The
// design stages K and V of one head and the tile's q in shared memory (K
// rows padded by one word, so the score loop reads K without bank
// conflicts), keeps the 32 x S scores in shared memory, and runs one warp
// per softmax row: 39 KB at S = 64, 91 KB at S = 128 and 173 KB at S = 256,
// under the 227 KB a block may ask for. The grid is batch * heads *
// ceil(S / 32) blocks.
#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // query rows per block
constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;

__host__ __device__ constexpr size_t smem_floats(int seq, int head_dim) {
  // q [T][D], k [S][D+1], v [S][D], p [T][S+1], row sums [T]
  return static_cast<size_t>(kTile) * head_dim +
         static_cast<size_t>(seq) * (head_dim + 1) +
         static_cast<size_t>(seq) * head_dim +
         static_cast<size_t>(kTile) * (seq + 1) + kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int seq, int heads, int head_dim,
                     float scale, int defer) {
  extern __shared__ float smem[];
  const int S = seq;
  const int D = head_dim;
  const int kd = D + 1;
  const int ps = S + 1;
  float* sq = smem;
  float* sk = sq + kTile * D;
  float* sv = sk + S * kd;
  float* sp = sv + S * D;
  float* srow = sp + kTile * ps;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int i0 = blockIdx.y * kTile;          // first query row of the tile
  const int nq = min(kTile, S - i0);          // query rows in the tile
  const size_t row_stride = static_cast<size_t>(heads) * D;
  const size_t base = static_cast<size_t>(b) * S * row_stride +
                      static_cast<size_t>(h) * D;

  for (int idx = threadIdx.x; idx < S * D; idx += kThreads) {
    const int s = idx / D;
    const int d = idx - s * D;
    const size_t g = base + s * row_stride + d;
    sk[s * kd + d] = ldot::to_f32(k[g]);
    sv[idx] = ldot::to_f32(v[g]);
  }
  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int s = idx / D;
    const int d = idx - s * D;
    sq[idx] = ldot::to_f32(q[base + (i0 + s) * row_stride + d]);
  }
  __syncthreads();

  // scores[i][j] = (q_i . k_j) * scale + bias[b][j], i over the tile's rows
  const float* brow = bias + static_cast<size_t>(b) * S;
  for (int idx = threadIdx.x; idx < nq * S; idx += kThreads) {
    const int i = idx / S;
    const int j = idx - i * S;
    const float* qi = sq + i * D;
    const float* kj = sk + j * kd;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(qi[d], kj[d], acc);
    sp[i * ps + j] = acc * scale + brow[j];
  }
  __syncthreads();

  // softmax, one warp per row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < nq; i += kThreads / 32) {
    float* row = sp + i * ps;
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
    if (defer) {
      for (int j = lane; j < S; j += 32) row[j] = ldot::round_to<T>(row[j]);
      if (lane == 0) srow[i] = sum;
    } else {
      for (int j = lane; j < S; j += 32)
        row[j] = ldot::round_to<T>(row[j] / sum);
    }
  }
  __syncthreads();

  // out[i][d] = sum_j p[i][j] v[j][d]  (then / row sum on the deferred path)
  for (int idx = threadIdx.x; idx < nq * D; idx += kThreads) {
    const int i = idx / D;
    const int d = idx - i * D;
    const float* pi = sp + i * ps;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(pi[j], sv[j * D + d], acc);
    if (defer) acc = acc / srow[i];
    out[base + (i0 + i) * row_stride + d] = ldot::from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* bias, void* out, int batch, int seq,
                   int heads, int head_dim, float scale, int defer,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be granted explicitly; grant
  // the largest supported shape once per instantiation
  static cudaError_t granted = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(kMaxSeq, kMaxHeadDim) * sizeof(float)));
  if (granted != cudaSuccess) return granted;
  const size_t smem = smem_floats(seq, head_dim) * sizeof(float);
  const dim3 grid(batch * heads, (seq + kTile - 1) / kTile);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), seq, heads,
      head_dim, scale, defer);
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
  if (dtype == ldot::kFloat32)
    return launch<float>(q, k, v, bias, out, batch, seq, heads, head_dim,
                         scale, defer, s);
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
