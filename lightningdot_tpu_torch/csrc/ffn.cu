// Fused feed-forward block, forward, in float32:
//   out = gelu(x W1 + b1) W2 + b2,  x [rows, H], W1 [H, I], W2 [I, H],
// and, for the backward, optionally h1 = x W1 + b1 and inter = gelu(h1)
// [rows, I].
//
// Replaces, in float32, the TPU kernel lightningdot_tpu/ops/ffn.py::
// _ffn_kernel (launched by _ffn_pallas; with_h1 and with_inter under the
// default "store" policy when the training path needs a gradient); bfloat16
// runs on the tensor cores (ffn_mma.cu). float32 serves the checks of the
// card against the CPU (the tensor cores have no float32 product). The
// kernel stays generic in its element type T. Numerics follow
// ops/ffn.py::_ffn_math: both products accumulate in float32, b1 is added
// in float32 and h1 is rounded to the compute dtype, the erf GELU is
// evaluated op by op with the compute dtype's rounding after each op (as
// the plain version does), then the second product, + b2, and one final
// rounding. GELU uses the exact erff; the TPU kernel's polynomial existed
// only because Mosaic had no erf.
//
// Bound: at serving batch sizes the rows are few (32 at batch 1) and the
// block reads the two weight matrices (2 x 768 x 3072 values) for very
// little arithmetic, so device-memory bytes and the number of SMs reading
// them bound it; at thousands of rows the float32 FMA rate does. As on the
// TPU, the [rows, I] intermediate never reaches device memory. To keep the
// card busy at 32 rows, the intermediate dimension is split across blocks
// as well as the rows: block (t, s) takes a 16-row tile t and the s-th range
// of 32-column chunks of I. Per chunk it computes fc1 for 16 x 32 values
// (the eight warps split the H reduction and sum their partials in a fixed
// order), applies b1 and GELU in shared memory, and accumulates the chunk's
// fc2 contribution into 16 x H float32 registers. With one range the block
// adds b2 and writes the output; with several, each writes its partial sum
// to a float32 workspace [splits, rows, H] and a second pass sums the
// partials in split order, adds b2 and casts. No atomics: the result does
// not depend on block scheduling, so rankings do not jitter between runs.
// Each (tile, chunk) belongs to exactly one block, which also writes that
// chunk's h1 and gelu(h1) when asked: the [rows, I] tensors the backward
// reads cost one write each and no extra pass.
//
// Weights are read in their [in, out] layout, so the lanes of a warp read
// neighbouring columns and every weight load is coalesced. Plain FMA, no
// tensor cores: simple and right first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;    // rows per tile
constexpr int kChunk = 32;   // intermediate columns per chunk (one per lane)
constexpr int kMaxHidden = 1024;

// kOut = ceil(H / kThreads): output columns each thread accumulates
template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
    ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
               const float* __restrict__ b1, const T* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out,
               T* __restrict__ h1_out, T* __restrict__ inter_out,
               float* __restrict__ workspace, int rows, int H, int I,
               int chunks_per_split) {
  extern __shared__ float smem[];
  float* xs = smem;                        // [kRows][H]
  float* part = xs + kRows * H;            // [kWarps][kRows][kChunk]
  float* gs = part + kWarps * kRows * kChunk;  // [kRows][kChunk]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_chunks = I / kChunk;
  const int chunk_begin = split * chunks_per_split;
  const int chunk_end = min(chunk_begin + chunks_per_split, n_chunks);

  // stage the x tile as float32; rows past the end are zero
  for (int idx = tid; idx < kRows * H; idx += kThreads) {
    const int r = idx / H;
    const int c = idx - r * H;
    xs[idx] = row0 + r < rows
                  ? ldot::to_f32(x[static_cast<size_t>(row0 + r) * H + c])
                  : 0.f;
  }
  __syncthreads();

  float acc_out[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc_out[r][j] = 0.f;

  // this warp's share of the H reduction in fc1
  const int k_per_warp = H / kWarps;
  const int k_begin = warp * k_per_warp;
  const int k_end = k_begin + k_per_warp;

  for (int chunk = chunk_begin; chunk < chunk_end; ++chunk) {
    const int col = chunk * kChunk + lane;

    // fc1 partial: 16 rows x this lane's column over the warp's k range
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = k_begin; k < k_end; k += 4) {
      const float wa = ldot::to_f32(w1[static_cast<size_t>(k) * I + col]);
      const float wb = ldot::to_f32(w1[static_cast<size_t>(k + 1) * I + col]);
      const float wc = ldot::to_f32(w1[static_cast<size_t>(k + 2) * I + col]);
      const float wd = ldot::to_f32(w1[static_cast<size_t>(k + 3) * I + col]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * H + k);
        float a = acc[r];
        a = fmaf(xv.x, wa, a);
        a = fmaf(xv.y, wb, a);
        a = fmaf(xv.z, wc, a);
        a = fmaf(xv.w, wd, a);
        acc[r] = a;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      part[(warp * kRows + r) * kChunk + lane] = acc[r];
    __syncthreads();

    // sum the warps' partials in warp order, + b1, round, GELU
    for (int idx = tid; idx < kRows * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int c = idx % kChunk;
      float h = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) h += part[w * kRows * kChunk + idx];
      const float h1 = ldot::round_to<T>(h + b1[chunk * kChunk + c]);
      const float g = ldot::gelu_rounded<T>(h1);
      gs[idx] = g;
      if (h1_out != nullptr && row0 + r < rows) {
        const size_t at =
            static_cast<size_t>(row0 + r) * I + chunk * kChunk + c;
        h1_out[at] = ldot::from_f32<T>(h1);
        inter_out[at] = ldot::from_f32<T>(g);
      }
    }
    __syncthreads();

    // fc2: acc_out[r][o] += gs[r][c] * W2[chunk * kChunk + c][o]
    for (int c = 0; c < kChunk; ++c) {
      const T* w2row = w2 + static_cast<size_t>(chunk * kChunk + c) * H;
      float wv[kOut];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const int o = tid + j * kThreads;
        wv[j] = o < H ? ldot::to_f32(w2row[o]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float g = gs[r * kChunk + c];
#pragma unroll
        for (int j = 0; j < kOut; ++j)
          acc_out[r][j] = fmaf(g, wv[j], acc_out[r][j]);
      }
    }
    // part and gs are rewritten by the next chunk
    __syncthreads();
  }

  const bool direct = gridDim.y == 1;
  float* ws = workspace + static_cast<size_t>(split) * rows * H;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r >= rows) break;
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int o = tid + j * kThreads;
      if (o >= H) continue;
      const size_t at = static_cast<size_t>(row0 + r) * H + o;
      if (direct)
        out[at] = ldot::from_f32<T>(acc_out[r][j] + b2[o]);
      else
        ws[at] = acc_out[r][j];
    }
  }
}

// out = cast(sum over splits of workspace + b2), splits summed in order
template <typename T>
__global__ void ffn_reduce_kernel(const float* __restrict__ workspace,
                                  const float* __restrict__ b2,
                                  T* __restrict__ out, int rows, int H,
                                  int splits) {
  const size_t n = static_cast<size_t>(rows) * H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += workspace[s * n + idx];
    out[idx] = ldot::from_f32<T>(acc + b2[idx % H]);
  }
}

size_t smem_bytes(int H) {
  return (static_cast<size_t>(kRows) * H + kWarps * kRows * kChunk +
          kRows * kChunk) *
         sizeof(float);
}

template <typename T, int kOut>
cudaError_t launch_main(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, void* h1,
                        void* inter, float* workspace, int rows, int H, int I,
                        int splits, cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      ffn_kernel<T, kOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxHidden)));
  if (granted != cudaSuccess) return granted;
  const int n_chunks = I / kChunk;
  const int per = (n_chunks + splits - 1) / splits;
  const dim3 grid((rows + kRows - 1) / kRows, splits);
  ffn_kernel<T, kOut><<<grid, kThreads, smem_bytes(H), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out),
      static_cast<T*>(h1), static_cast<T*>(inter), workspace, rows, H, I,
      per);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, void* out, void* h1,
                     void* inter, float* workspace, int rows, int H, int I,
                     int splits, cudaStream_t stream) {
  const int out_per_thread = (H + kThreads - 1) / kThreads;
  cudaError_t err;
  switch (out_per_thread) {
    case 1:
      err = launch_main<T, 1>(x, w1, b1, w2, b2, out, h1, inter, workspace,
                              rows, H, I, splits, stream);
      break;
    case 2:
      err = launch_main<T, 2>(x, w1, b1, w2, b2, out, h1, inter, workspace,
                              rows, H, I, splits, stream);
      break;
    case 3:
      err = launch_main<T, 3>(x, w1, b1, w2, b2, out, h1, inter, workspace,
                              rows, H, I, splits, stream);
      break;
    case 4:
      err = launch_main<T, 4>(x, w1, b1, w2, b2, out, h1, inter, workspace,
                              rows, H, I, splits, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(rows) * H;
  const int threads = 256;
  const int blocks = static_cast<int>(
      (n + threads - 1) / threads < 4096 ? (n + threads - 1) / threads
                                         : 4096);
  ffn_reduce_kernel<T><<<blocks, threads, 0, stream>>>(
      workspace, b2, static_cast<T*>(out), rows, H, splits);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, H]; w1: [H, I]; w2: [I, H] (all contiguous float32, dtype
// code 0; any other code is refused); b1 [I], b2 [H] float32. h1, inter:
// [rows, I] float32, both given or both null. workspace: float32
// [splits, rows, H] when splits > 1 (unused otherwise). H % 32 == 0,
// H <= 1024, I % 32 == 0, 1 <= splits <= I / 32.
extern "C" int ldot_ffn(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, void* h1,
                        void* inter, float* workspace, int rows, int H, int I,
                        int splits, int dtype, void* stream) {
  if (rows <= 0 || H <= 0 || H % 32 != 0 || H > kMaxHidden || I <= 0 ||
      I % kChunk != 0 || splits < 1 || splits > I / kChunk ||
      (splits > 1 && workspace == nullptr) ||
      ((h1 == nullptr) != (inter == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return dispatch<float>(x, w1, b1, w2, b2, out, h1, inter, workspace,
                           rows, H, I, splits, s);
  return cudaErrorInvalidValue;   // bfloat16: ldot_ffn_mma (ffn_mma.cu)
}
