// Fused int8 feed-forward block of the int8 serving tower, forward only:
//   xq, xs = quant_rows(x)                    (per-row symmetric int8)
//   h1     = bf16(int32(xq W1q) * xs * s1 + b1)
//   g      = gelu(h1)                         (bf16, op by op)
//   gq, gs = quant_rows(g)                    (over the whole row of I)
//   out    = bf16(int32(gq W2q) * gs * s2 + b2)
// x, out [rows, H] bfloat16; W1q [H, I] and W2q [I, H] int8, stored
// out-major (W1q^T [I, H] and W2q^T [H, I] contiguous, the torch Linear
// layout); s1, b1 [I] and s2, b2 [H] float32.
//
// Replaces the TPU kernel
// lightningdot_tpu/ops/experimental/ffn_int8_pallas.py::_ffn_int8_kernel
// (launched by ffn_int8_pallas). Numerics follow the plain version,
// ops/ffn_int8.py::_ffn_int8_math (itself lightningdot_tpu/ops/ffn_int8.py::
// _ffn_int8_math with erf="exact"): scale = max(max|row|, 1e-8) * (1/127)
// (the float32 reciprocal multiply that XLA makes of "/ 127" under jit),
// round(v / scale) by IEEE division and rintf (half to even, as
// torch.round), clipped to +-127; exact int32 products; the dequant
// epilogue in the twin's order, acc * xs * s + b, with __fmul_rn/__fadd_rn
// so that nvcc cannot contract it into an FMA; GELU op by op in bf16
// (common.cuh, the bf16 FFN's code). Every step is exact or rounds as the twin does, so the result
// matches the twin bit for bit wherever the twin's own elementwise ops do.
//
// Design. The requantization of the intermediate needs the max of a whole
// row of I = 3072 values, so fc2 cannot start before every fc1 column of the
// row exists. Of the two right designs (one block per row tile holding the
// whole intermediate, or two passes through device memory) this takes the
// second: at serving batch sizes the rows are few (32 at batch 1), and one
// block per 16-row tile would leave 130 of 132 SMs idle. Three launches:
//   1. fc1 + GELU, grid (row tiles, I / 64): each block quantizes its 16
//      rows of x (the row scale over all of H first), computes 16 x 64
//      columns of h1 with __dp4a over the full H, applies the epilogue and
//      GELU, writes the bf16 intermediate and each row's max |g| over its 64
//      columns;
//   2. fc2, grid (row tiles, H / 64, splits): each block reduces the row
//      maxima to the row scale, requantizes its K range of the intermediate
//      on load and sums its share of the I reduction with __dp4a. With one
//      split it writes the output; with several, its int32 partial sums go
//      to a workspace [splits, rows, H];
//   3. (splits > 1) sums the int32 partials, applies the epilogue, writes
//      the output. Integer sums are exact in any order, so the result does
//      not depend on the split or on block scheduling.
//
// Bound: at 32 rows the block reads the int8 weights (2 x 768 x 3072 bytes,
// half the bf16 FFN's) for little arithmetic, so the number of SMs pulling
// weights bounds it; at thousands of rows the __dp4a rate (4 int8 MACs per
// instruction on the int32 pipes, a quarter of the tensor cores' int8 rate
// or less) does. Both matrices are read by 64-wide k-slabs staged through
// shared memory: the out-major layout makes four consecutive k of one
// output column one 32-bit word, which is what __dp4a takes. mma.sync /
// wgmma int8 tiles are for a later performance PR.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // rows per tile
constexpr int kCols = 64;          // output columns per block
constexpr int kK = 64;             // reduction depth staged per step
constexpr int kKW = kK / 4;        // packed int8 words per staged row
constexpr int kBStride = kKW + 1;  // B tile row stride in words (banks)
constexpr float kInv127 = 1.0f / 127.0f;  // ops/ffn_int8.py: INV_127

// round(v / scale) clipped to [-127, 127], as the twin's _quant_rows
__device__ __forceinline__ int quant(float v, float scale) {
  const float q = rintf(v / scale);
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// Stage the kK-deep slab of 64 out-major weight columns starting at
// (col0, k0) into bs[col][word]: word w of column c holds k0 + 4w .. +3.
__device__ __forceinline__ void stage_weights(const int8_t* __restrict__ wt,
                                              int K, int col0, int k0,
                                              uint32_t* bs) {
  const int word = threadIdx.x % kKW;
#pragma unroll
  for (int i = 0; i < kCols * kKW / kThreads; ++i) {
    const int c = threadIdx.x / kKW + i * (kThreads / kKW);
    bs[c * kBStride + word] = *reinterpret_cast<const uint32_t*>(
        wt + static_cast<size_t>(col0 + c) * K + k0 + 4 * word);
  }
}

// Stage kK values of each of the 16 rows of a bf16 matrix [rows, K],
// quantized by the row's scale, into as[row][word]; rows past the end are 0.
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ a,
                                           int rows, int K, int row0, int k0,
                                           const float* scale, uint32_t* as) {
  const int r = threadIdx.x / kKW;
  const int word = threadIdx.x % kKW;
  uint32_t packed = 0;
  if (row0 + r < rows) {
    const __nv_bfloat16* p =
        a + static_cast<size_t>(row0 + r) * K + k0 + 4 * word;
    const float s = scale[r];
    packed = pack4(quant(__bfloat162float(p[0]), s),
                   quant(__bfloat162float(p[1]), s),
                   quant(__bfloat162float(p[2]), s),
                   quant(__bfloat162float(p[3]), s));
  }
  as[r * kKW + word] = packed;
}

// acc[j] += row r of as . column (cc + 16 j) of bs, over one staged slab
__device__ __forceinline__ void dot_slab(const uint32_t* as,
                                         const uint32_t* bs, int r, int cc,
                                         int acc[4]) {
#pragma unroll
  for (int w = 0; w < kKW; ++w) {
    const int a = static_cast<int>(as[r * kKW + w]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = __dp4a(a, static_cast<int>(bs[(cc + 16 * j) * kBStride + w]),
                      acc[j]);
  }
}

// acc * xs * s + b in the twin's order, never contracted into an FMA
__device__ __forceinline__ float dequant(int acc, float xs, float s,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s), b);
}

// 1. fc1 + GELU. Block (tile, chunk): rows tile*16.., columns chunk*64..
__global__ void __launch_bounds__(kThreads)
    fc1_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w1t, const float* __restrict__ s1,
               const float* __restrict__ b1, __nv_bfloat16* __restrict__ inter,
               float* __restrict__ chunk_max, int rows, int H, int I) {
  __shared__ float xs[kRows];
  __shared__ uint32_t as[kRows * kKW];
  __shared__ uint32_t bs[kCols * kBStride];
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // the row scales, over all of H: one warp per two rows
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float m = 0.f;
    if (row0 + r < rows) {
      const __nv_bfloat16* xr = x + static_cast<size_t>(row0 + r) * H;
      for (int c = lane; c < H; c += 32)
        m = fmaxf(m, fabsf(__bfloat162float(xr[c])));
    }
    m = ldot::warp_max(m);
    if (lane == 0) xs[r] = fmaxf(m, 1e-8f) * kInv127;
  }
  __syncthreads();

  const int r = threadIdx.x / 16;
  const int cc = threadIdx.x % 16;
  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < H; k0 += kK) {
    stage_rows(x, rows, H, row0, k0, xs, as);
    stage_weights(w1t, H, col0, k0, bs);
    __syncthreads();
    dot_slab(as, bs, r, cc, acc);
    __syncthreads();
  }

  const int row = row0 + r;
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + cc + 16 * j;
    const float h1 = ldot::round_to<__nv_bfloat16>(
        dequant(acc[j], xs[r], s1[col], b1[col]));
    const float g = ldot::gelu_rounded<__nv_bfloat16>(h1);
    m = fmaxf(m, fabsf(g));
    if (row < rows)
      inter[static_cast<size_t>(row) * I + col] = __float2bfloat16_rn(g);
  }
  // max over the 16 threads of this row (one half-warp)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (cc == 0 && row < rows)
    chunk_max[static_cast<size_t>(row) * gridDim.y + blockIdx.y] = m;
}

// 2. fc2 over one K range. Block (tile, column chunk, split).
__global__ void __launch_bounds__(kThreads)
    fc2_kernel(const __nv_bfloat16* __restrict__ inter,
               const float* __restrict__ chunk_max, int n_max,
               const int8_t* __restrict__ w2t, const float* __restrict__ s2,
               const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
               int* __restrict__ workspace, float* __restrict__ row_scale,
               int rows, int H, int I, int k_per_split) {
  __shared__ float gs[kRows];
  __shared__ uint32_t as[kRows * kKW];
  __shared__ uint32_t bs[kCols * kBStride];
  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int split = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // the intermediate's row scales, from fc1's per-chunk maxima
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float m = 0.f;
    if (row0 + r < rows)
      for (int c = lane; c < n_max; c += 32)
        m = fmaxf(m, chunk_max[static_cast<size_t>(row0 + r) * n_max + c]);
    m = ldot::warp_max(m);
    if (lane == 0) {
      gs[r] = fmaxf(m, 1e-8f) * kInv127;
      if (blockIdx.y == 0 && split == 0 && row0 + r < rows)
        row_scale[row0 + r] = gs[r];
    }
  }
  __syncthreads();

  const int r = threadIdx.x / 16;
  const int cc = threadIdx.x % 16;
  int acc[4] = {0, 0, 0, 0};
  const int k_begin = split * k_per_split;
  const int k_end = min(k_begin + k_per_split, I);
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
    stage_rows(inter, rows, I, row0, k0, gs, as);
    stage_weights(w2t, I, col0, k0, bs);
    __syncthreads();
    dot_slab(as, bs, r, cc, acc);
    __syncthreads();
  }

  const int row = row0 + r;
  if (row >= rows) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + cc + 16 * j;
    const size_t at = static_cast<size_t>(row) * H + col;
    if (gridDim.z == 1)
      out[at] = __float2bfloat16_rn(dequant(acc[j], gs[r], s2[col], b2[col]));
    else
      workspace[static_cast<size_t>(split) * rows * H + at] = acc[j];
  }
}

// 3. out = epilogue(sum over splits of the int32 partials)
__global__ void fc2_reduce_kernel(const int* __restrict__ workspace,
                                  const float* __restrict__ row_scale,
                                  const float* __restrict__ s2,
                                  const float* __restrict__ b2,
                                  __nv_bfloat16* __restrict__ out, int rows,
                                  int H, int splits) {
  const size_t n = static_cast<size_t>(rows) * H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       idx < n; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += workspace[s * n + idx];
    const int col = static_cast<int>(idx % H);
    out[idx] = __float2bfloat16_rn(
        dequant(acc, row_scale[idx / H], s2[col], b2[col]));
  }
}

}  // namespace

// x, out: [rows, H] bfloat16; w1t: [I, H] and w2t: [H, I] int8 (the
// quantized kernels, out-major); s1, b1: [I], s2, b2: [H] float32.
// Scratch: inter bfloat16 [rows, I]; chunk_max float32 [rows, I / 64];
// row_scale float32 [rows]; workspace int32 [splits, rows, H] when
// splits > 1. H % 64 == 0, I % 64 == 0, 1 <= splits <= I / 64.
extern "C" int ldot_ffn_int8(const void* x, const void* w1t, const float* s1,
                             const float* b1, const void* w2t,
                             const float* s2, const float* b2, void* out,
                             void* inter, float* chunk_max, float* row_scale,
                             int* workspace, int rows, int H, int I,
                             int splits, void* stream) {
  if (rows <= 0 || H <= 0 || H % kCols != 0 || I <= 0 || I % kCols != 0 ||
      splits < 1 || splits > I / kK || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (rows + kRows - 1) / kRows;
  const int n_max = I / kCols;
  fc1_kernel<<<dim3(tiles, n_max), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1t),
      s1, b1, static_cast<__nv_bfloat16*>(inter), chunk_max, rows, H, I);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int k_chunks = I / kK;
  const int per = (k_chunks + splits - 1) / splits;
  fc2_kernel<<<dim3(tiles, H / kCols, splits), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(inter), chunk_max, n_max,
      static_cast<const int8_t*>(w2t), s2, b2,
      static_cast<__nv_bfloat16*>(out), workspace, row_scale, rows, H, I,
      per * kK);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(rows) * H;
  const int threads = 256;
  const int blocks = static_cast<int>(
      (n + threads - 1) / threads < 4096 ? (n + threads - 1) / threads
                                         : 4096);
  fc2_reduce_kernel<<<blocks, threads, 0, s>>>(
      workspace, row_scale, s2, b2, static_cast<__nv_bfloat16*>(out), rows,
      H, splits);
  return cudaGetLastError();
}
