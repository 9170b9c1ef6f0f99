// Row LayerNorm, forward and backward, with the dropout-and-residual
// prologue of dropout_add_ln:
//
//   u   = (x * keep) * s + res     (each op rounded to T; keep, res optional)
//   out = (u - mean) * rsqrt(var + eps) * scale + bias
//
// and its RMS mode (RMSNorm: mean taken as 0, no bias; the Moonlight
// tower's norms, models/moonlight.py), which has no TPU counterpart:
//
//   out = u * rsqrt(mean(u^2) + eps) * scale
//
// The forward replaces the TPU kernel lightningdot_tpu/ops/layernorm.py::
// _ln_kernel (launched by _ln_pallas) and the mask-and-add in front of it
// (lightningdot_tpu/ops/fused.py::_dal_math). The backward is the card's
// counterpart of what XLA fuses on the TPU: the jnp VJP _layer_norm_bwd
// (ops/layernorm.py:74-95) and fused.py::_dal_bwd (:114-126), which
// recomputes u. Statistics are float32 two-pass (mean, then the centred sum
// of squares) over a row held in registers; activations are float32 or
// bfloat16, scale and bias float32.
//
// Bound: device-memory bytes. A row is read once and written once (the
// backward reads x, res, keep and g and writes du, dx), at a few operations
// per element. The design:
// - every access is a 16-byte vector (8 bf16 or 4 float32; keep as 8 or 4
//   bytes), neighbouring threads on neighbouring vectors; scale and bias
//   as float4; the row is held in registers as T (u is a value of T);
// - many rows: a warp per row (two at H 1,536), each thread holding 24
//   elements, four rows to a block, few registers so that many rows are
//   in flight on an SM; at most kFewRows rows (the batch-1 to batch-32
//   queries): one row per block, one vector per thread (96 threads
//   at H 768 bf16), the warps' sums joined through shared memory, so a
//   32-row call spreads over 32 SMs instead of walking long chains on 4,
//   and scale and bias are read with the row, before the reductions;
// - the prologue reproduces the plain version's roundings bit for bit with
//   __fmul_rn/__fadd_rn (no FMA contraction) and a round to T after each
//   op; u is never written;
// - the backward keeps u (as T) and g in registers, writes du (and, with a
//   mask, dx = du * keep * s), and sums dscale = sum g * xhat and dbias =
//   sum g per thread over the rows of its block; each block writes its
//   partial sums to a float32 workspace and a second launch sums them in a
//   fixed order, with no atomics, so a launch repeats its bits.
// - rows wider than 1,536 (the VQA head's 3,072 and 6,144): the many-rows
//   instantiations unchanged, one row a block of up to 256 threads (24
//   elements a thread: 3 bf16 or 6 float32 vectors), at any row count; the
//   backward's threads a row are rounded up to a power of 2 (128 or 256),
//   so that its row groups (2 or 1 a block) still add in a fixed tree. The
//   plans up to 1,536 are the ones above, launch for launch.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxHidden = 1536;
constexpr int kMaxThreads = kMaxHidden / 4;   // a float4 per thread
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPerThread = 24;       // elements a thread holds (many rows)
// the widest row: 256 threads of kPerThread elements, a row per block
constexpr int kWideThreads = 256;
constexpr int kWideMaxHidden = kWideThreads * kPerThread;
static_assert(kWideThreads <= kMaxThreads, "a wide row's warps fit slots");
// at most this many rows: one row per block. On an H100 the spread layout
// was the faster up to 1,024 rows of 768 and the slower from 2,048
// (scripts/perf_torch_layernorm.py)
constexpr int kFewRows = 1024;
constexpr int kManyThreads = 128;    // threads of a block (many rows)
constexpr int kBwdThreads = 256;     // threads of a backward block
constexpr int kSumWarps = 8;         // warps of the summing launch

// 16 bytes of T, and the keep bytes beside them
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  using Raw = float4;
  using Mask = uint32_t;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Raw = uint4;
  using Mask = uint2;
};

__device__ __forceinline__ void unpack(const float4& r, float* f) {
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

__device__ __forceinline__ void unpack(const uint4& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void pack(const float* f, float4& r) {
  r = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void pack(const float* f, uint4& r) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
}

__device__ __forceinline__ void unpack_mask(uint32_t m, float* k) {
#pragma unroll
  for (int e = 0; e < 4; ++e) k[e] = (m >> (8 * e)) & 0xffu ? 1.f : 0.f;
}

__device__ __forceinline__ void unpack_mask(const uint2& m, float* k) {
  unpack_mask(m.x, k);
  unpack_mask(m.y, k + 4);
}

// scale or bias at the elements of vector `vec`, as float4 loads
template <int E>
__device__ __forceinline__ void load_param(const float* __restrict__ p,
                                           int vec, float* f) {
  const float4* v = reinterpret_cast<const float4*>(p) + vec * (E / 4);
#pragma unroll
  for (int q = 0; q < E / 4; ++q) unpack(v[q], f + 4 * q);
}

// inverted dropout given the keep value k (0 or 1): (a * k) * s, each
// product rounded to T as ops/layernorm.py::apply_keep rounds it
template <typename T>
__device__ __forceinline__ float apply_keep(float a, float k, float s) {
  return ldot::round_to<T>(__fmul_rn(ldot::round_to<T>(__fmul_rn(a, k)), s));
}

// u at vector `vec` of the row at `base`: x, masked by `mask` (kKeep),
// plus res (kRes), rounded to T after each op
template <typename T, bool kRes, bool kKeep>
__device__ __forceinline__ void load_u(const T* __restrict__ x,
                                       const T* __restrict__ res,
                                       const typename Vec<T>::Mask& mask,
                                       size_t base, int vec, float s,
                                       float* u) {
  using V = Vec<T>;
  unpack(reinterpret_cast<const typename V::Raw*>(x + base)[vec], u);
  if constexpr (kKeep) {
    float k[V::kElems];
    unpack_mask(mask, k);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e) u[e] = apply_keep<T>(u[e], k[e], s);
  }
  if constexpr (kRes) {
    float r[V::kElems];
    unpack(reinterpret_cast<const typename V::Raw*>(res + base)[vec], r);
#pragma unroll
    for (int e = 0; e < V::kElems; ++e)
      u[e] = ldot::round_to<T>(__fadd_rn(u[e], r[e]));
  }
}

template <typename T>
__device__ __forceinline__ typename Vec<T>::Mask load_mask(
    const uint8_t* __restrict__ keep, size_t base, int vec) {
  return reinterpret_cast<const typename Vec<T>::Mask*>(keep + base)[vec];
}

// The sum of v over the threads of this thread's row (threadIdx.y): a
// shuffle tree in each warp, then the row's warps in order through `slots`
// (one float per warp of the block). A fixed order, so a launch repeats its
// bits. Every thread of the block calls it; with more than one warp per row
// the caller syncs before `slots` is written again.
__device__ __forceinline__ float row_sum(float v, float* slots) {
  v = ldot::warp_sum(v);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  float* mine = slots + threadIdx.y * warps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += mine[w];
  return s;
}

// blockDim (threads per row, rows per block); a thread takes vectors
// threadIdx.x + j * blockDim.x, j < kVecs, of its row
template <typename T, int kVecs, bool kRes, bool kKeep, bool kRms>
__global__ void __launch_bounds__(kMaxThreads)
    layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const uint8_t* __restrict__ keep,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int rows, int hidden, float eps, float keep_scale) {
  using V = Vec<T>;
  constexpr int E = V::kElems;
  __shared__ float slots[2][kMaxWarps];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int nvec = hidden / E;
  const size_t base = static_cast<size_t>(row) * hidden;

  // With one vector a thread (few rows), scale and bias are read with the
  // row, so that their latency hides under the row's. With more, they are
  // read at the output, from L1: held across the reductions they took 48
  // registers a thread and halved the rows in flight on an SM.
  constexpr bool kEarly = kVecs == 1;
  typename V::Raw ur[kVecs];   // u as T: exact, and half the registers
  float sc[kVecs][E], bi[kVecs][E];
  bool in[kVecs];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int vec = threadIdx.x + j * blockDim.x;
    in[j] = row < rows && vec < nvec;
    float u[E];
    if (in[j]) {
      typename V::Mask mask{};
      if constexpr (kKeep) mask = load_mask<T>(keep, base, vec);
      load_u<T, kRes, kKeep>(x, res, mask, base, vec, keep_scale, u);
      if constexpr (kEarly) {
        load_param<E>(scale, vec, sc[j]);
        if constexpr (!kRms) load_param<E>(bias, vec, bi[j]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) u[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sum += u[e];
    pack(u, ur[j]);
  }
  const float mean = kRms ? 0.f : row_sum(sum, slots[0]) / hidden;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (!in[j]) continue;
    float u[E];
    unpack(ur[j], u);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float d = __fsub_rn(u[e], mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
  }
  const float inv = rsqrtf(row_sum(sq, slots[1]) / hidden + eps);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if (!in[j]) continue;
    const int vec = threadIdx.x + j * blockDim.x;
    float u[E], y[E];
    unpack(ur[j], u);
    if constexpr (!kEarly) {
      load_param<E>(scale, vec, sc[j]);
      if constexpr (!kRms) load_param<E>(bias, vec, bi[j]);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      y[e] = __fmul_rn(__fmul_rn(__fsub_rn(u[e], mean), inv), sc[j][e]);
      if constexpr (!kRms) y[e] = __fadd_rn(y[e], bi[j][e]);
    }
    typename V::Raw r;
    pack(y, r);
    reinterpret_cast<typename V::Raw*>(out + base)[vec] = r;
  }
}

// blockDim (threads per row, rows per block R, a power of 2); the block
// walks row groups blockIdx.x, + gridDim.x, ... and writes its partial sums
// of dscale (the first `hidden` floats) and dbias to partial[blockIdx.x]
template <typename T, bool kRes, bool kKeep, bool kRms>
__global__ void __launch_bounds__(kBwdThreads, 2)
    layernorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                         const uint8_t* __restrict__ keep,
                         const float* __restrict__ scale,
                         const T* __restrict__ g, T* __restrict__ du,
                         T* __restrict__ dx, float* __restrict__ partial,
                         int rows, int hidden, float eps, float keep_scale) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int E = V::kElems;
  constexpr int kVecs = kPerThread / E;
  __shared__ float slots[4][kMaxWarps];
  // half the row groups' sums: (R / 2) x 2 x kPerThread x threads per row
  // = kBwdThreads x kPerThread floats
  __shared__ float tree[kBwdThreads * kPerThread];
  const int nvec = hidden / E;

  float acc_s[kVecs][E], acc_b[kVecs][E];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[j][e] = acc_b[j][e] = 0.f;
  }

  for (int first = blockIdx.x * blockDim.y; first < rows;
       first += gridDim.x * blockDim.y) {
    const int row = first + threadIdx.y;
    const size_t base = static_cast<size_t>(row) * hidden;
    Raw ur[kVecs], gr[kVecs];
    typename V::Mask mask[kVecs];
    bool in[kVecs];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int vec = threadIdx.x + j * blockDim.x;
      in[j] = row < rows && vec < nvec;
      float u[E];
      mask[j] = typename V::Mask{};
      if (in[j]) {
        if constexpr (kKeep) mask[j] = load_mask<T>(keep, base, vec);
        load_u<T, kRes, kKeep>(x, res, mask[j], base, vec, keep_scale, u);
        gr[j] = reinterpret_cast<const Raw*>(g + base)[vec];
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) u[e] = 0.f;
        gr[j] = Raw{};
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sum += u[e];
      pack(u, ur[j]);   // exact: u is already a value of T
    }
    const float mean = kRms ? 0.f : row_sum(sum, slots[0]) / hidden;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (!in[j]) continue;
      float u[E];
      unpack(ur[j], u);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = __fsub_rn(u[e], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    const float inv = rsqrtf(row_sum(sq, slots[1]) / hidden + eps);

    // the row means of gs = g * scale and of gs * xhat; the column sums
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (!in[j]) continue;
      float u[E], gv[E], sc[E];
      unpack(ur[j], u);
      unpack(gr[j], gv);
      load_param<E>(scale, threadIdx.x + j * blockDim.x, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = __fmul_rn(__fsub_rn(u[e], mean), inv);
        const float gs = __fmul_rn(gv[e], sc[e]);
        s1 = __fadd_rn(s1, gs);
        s2 = __fadd_rn(s2, __fmul_rn(gs, xh));
        acc_s[j][e] = __fadd_rn(acc_s[j][e], __fmul_rn(gv[e], xh));
        acc_b[j][e] = __fadd_rn(acc_b[j][e], gv[e]);
      }
    }
    const float m1 = kRms ? 0.f : row_sum(s1, slots[2]) / hidden;
    const float m2 = row_sum(s2, slots[3]) / hidden;

    // du = inv * (gs - mean(gs) - xhat * mean(gs * xhat)), rounded to T
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      if (!in[j]) continue;
      const int vec = threadIdx.x + j * blockDim.x;
      float u[E], gv[E], sc[E], d[E];
      unpack(ur[j], u);
      unpack(gr[j], gv);
      load_param<E>(scale, vec, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = __fmul_rn(__fsub_rn(u[e], mean), inv);
        const float gs = __fmul_rn(gv[e], sc[e]);
        d[e] = ldot::round_to<T>(__fmul_rn(
            inv, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xh, m2))));
      }
      Raw r;
      pack(d, r);
      reinterpret_cast<Raw*>(du + base)[vec] = r;
      if constexpr (kKeep) {
        float k[E];
        unpack_mask(mask[j], k);
#pragma unroll
        for (int e = 0; e < E; ++e)
          d[e] = apply_keep<T>(d[e], k[e], keep_scale);
        pack(d, r);
        reinterpret_cast<Raw*>(dx + base)[vec] = r;
      }
    }
    if (blockDim.x > 32) __syncthreads();   // slots are written again
  }

  // The block's partial sums: the row groups' sums added pairwise in a
  // fixed tree (group y takes group y + half, half = R/2, R/4, ... 1),
  // through slices of shared memory laid out thread-major, so that the
  // stores and loads are free of bank conflicts and of read-modify-write
  // chains; group 0 writes the block's row of partials.
  constexpr int kAcc = 2 * kVecs * E;
  for (int half = blockDim.y / 2; half > 0; half /= 2) {
    if (threadIdx.y >= half && threadIdx.y < 2 * half) {
      float* slice = tree + (threadIdx.y - half) * kAcc * blockDim.x;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          slice[(j * E + e) * blockDim.x + threadIdx.x] = acc_s[j][e];
          slice[((kVecs + j) * E + e) * blockDim.x + threadIdx.x] =
              acc_b[j][e];
        }
      }
    }
    __syncthreads();
    if (threadIdx.y < half) {
      const float* slice = tree + threadIdx.y * kAcc * blockDim.x;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          acc_s[j][e] = __fadd_rn(
              acc_s[j][e], slice[(j * E + e) * blockDim.x + threadIdx.x]);
          acc_b[j][e] = __fadd_rn(
              acc_b[j][e],
              slice[((kVecs + j) * E + e) * blockDim.x + threadIdx.x]);
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.y == 0) {
    float* mine = partial + static_cast<size_t>(blockIdx.x) * 2 * hidden;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int vec = threadIdx.x + j * blockDim.x;
      if (vec >= nvec) continue;
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        reinterpret_cast<float4*>(mine)[vec * (E / 4) + q] = make_float4(
            acc_s[j][4 * q], acc_s[j][4 * q + 1], acc_s[j][4 * q + 2],
            acc_s[j][4 * q + 3]);
        reinterpret_cast<float4*>(mine + hidden)[vec * (E / 4) + q] =
            make_float4(acc_b[j][4 * q], acc_b[j][4 * q + 1],
                        acc_b[j][4 * q + 2], acc_b[j][4 * q + 3]);
      }
    }
  }
}

// dscale and dbias from the partials [blocks][2 * hidden]: column c summed
// over the blocks in a fixed order (warp w takes blocks w, w + 8, ... in
// order, then the warps' sums in warp order); no atomics
__global__ void __launch_bounds__(32 * kSumWarps)
    layernorm_bwd_sum_kernel(const float* __restrict__ partial, int blocks,
                             int hidden, float* __restrict__ dscale,
                             float* __restrict__ dbias) {
  __shared__ float part[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = 2 * hidden;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < width) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kSumWarps)
      s += partial[static_cast<size_t>(b) * width + c];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += part[w][lane];
    if (c < hidden)
      dscale[c] = t;
    else
      dbias[c - hidden] = t;
  }
}

int round_up32(int n) { return (n + 31) / 32 * 32; }

template <typename T, bool kRes, bool kKeep, bool kRms = false>
cudaError_t forward(const void* x, const void* res, const void* keep,
                    const float* scale, const float* bias, void* out,
                    int rows, int hidden, float eps, float keep_scale,
                    cudaStream_t stream) {
  constexpr int E = Vec<T>::kElems;
  constexpr int kVecs = kPerThread / E;
  const int nvec = hidden / E;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const uint8_t* kt = static_cast<const uint8_t*>(keep);
  T* ot = static_cast<T*>(out);
  if (rows <= kFewRows && hidden <= kMaxHidden) {
    layernorm_fwd_kernel<T, 1, kRes, kKeep, kRms>
        <<<rows, dim3(round_up32(nvec), 1), 0, stream>>>(
            xt, rt, kt, scale, bias, ot, rows, hidden, eps, keep_scale);
  } else {
    const int per_row = round_up32((nvec + kVecs - 1) / kVecs);
    const int rows_per_block = per_row < kManyThreads
                                   ? kManyThreads / per_row : 1;
    layernorm_fwd_kernel<T, kVecs, kRes, kKeep, kRms>
        <<<(rows + rows_per_block - 1) / rows_per_block,
           dim3(per_row, rows_per_block), 0, stream>>>(
            xt, rt, kt, scale, bias, ot, rows, hidden, eps, keep_scale);
  }
  return cudaGetLastError();
}

template <typename T, bool kRes, bool kKeep, bool kRms = false>
cudaError_t backward(const void* x, const void* res, const void* keep,
                     const float* scale, const void* g, void* du, void* dx,
                     float* partial, float* dscale, float* dbias, int rows,
                     int hidden, int blocks, float eps, float keep_scale,
                     cudaStream_t stream) {
  constexpr int E = Vec<T>::kElems;
  constexpr int kVecs = kPerThread / E;
  // 32 or 64 threads a row up to H 1,536: 8 or 4 row groups, a power of 2
  // for the tree that adds their sums; wider rows take a power of 2 of
  // threads, up to 256 (1 row group)
  int per_row = round_up32((hidden / E + kVecs - 1) / kVecs);
  if (hidden > kMaxHidden)
    while (per_row & (per_row - 1)) per_row += per_row & -per_row;
  const int groups = kBwdThreads / per_row;
  if (kBwdThreads % per_row || (groups & (groups - 1)))
    return cudaErrorInvalidValue;
  layernorm_bwd_kernel<T, kRes, kKeep, kRms>
      <<<blocks, dim3(per_row, groups), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(res),
          static_cast<const uint8_t*>(keep), scale,
          static_cast<const T*>(g), static_cast<T*>(du), static_cast<T*>(dx),
          partial, rows, hidden, eps, keep_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layernorm_bwd_sum_kernel<<<(2 * hidden + 31) / 32, 32 * kSumWarps, 0,
                             stream>>>(partial, blocks, hidden, dscale,
                                       dbias);
  return cudaGetLastError();
}

bool shape_ok(int rows, int hidden, const void* res, const void* keep) {
  return rows > 0 && hidden > 0 && hidden <= kWideMaxHidden &&
         hidden % 8 == 0 &&
         (keep == nullptr || res != nullptr);
}

}  // namespace

// x, res, out: [rows, hidden] contiguous, float32 or bfloat16 (dtype code);
// keep: bool [rows, hidden] or null (then keep_scale is unused), only with
// res; res may be null; scale, bias: [hidden] float32. hidden a multiple of
// 8 up to 6,144; every pointer 16-byte aligned.
extern "C" int ldot_layernorm(const void* x, const void* res,
                              const void* keep, const float* scale,
                              const float* bias, void* out, int rows,
                              int hidden, float eps, float keep_scale,
                              int dtype, void* stream) {
  if (!shape_ok(rows, hidden, res, keep)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDOT_LN_FWD(T)                                                      \
  (keep ? forward<T, true, true>(x, res, keep, scale, bias, out, rows,      \
                                 hidden, eps, keep_scale, s)                \
   : res ? forward<T, true, false>(x, res, keep, scale, bias, out, rows,    \
                                   hidden, eps, keep_scale, s)              \
         : forward<T, false, false>(x, res, keep, scale, bias, out, rows,   \
                                    hidden, eps, keep_scale, s))
  if (dtype == ldot::kFloat32) return LDOT_LN_FWD(float);
  if (dtype == ldot::kBFloat16) return LDOT_LN_FWD(__nv_bfloat16);
#undef LDOT_LN_FWD
  return cudaErrorInvalidValue;
}

// The backward of ldot_layernorm's function: du = d out / d u, in x's dtype
// (also d res); with keep, dx = du * keep * keep_scale (dx is null without
// keep: then d x = du); dscale, dbias float32 [hidden], summed over the rows
// through partial, float32 [blocks, 2 * hidden] (blocks >= 1; blocks past
// the last row group write zeros). g: [rows, hidden] in x's dtype.
extern "C" int ldot_layernorm_bwd(const void* x, const void* res,
                                  const void* keep, const float* scale,
                                  const void* g, void* du, void* dx,
                                  float* partial, float* dscale,
                                  float* dbias, int rows, int hidden,
                                  int blocks, float eps, float keep_scale,
                                  int dtype, void* stream) {
  if (!shape_ok(rows, hidden, res, keep) || blocks <= 0 ||
      (keep != nullptr) != (dx != nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDOT_LN_BWD(T)                                                      \
  (keep ? backward<T, true, true>(x, res, keep, scale, g, du, dx, partial,  \
                                  dscale, dbias, rows, hidden, blocks, eps, \
                                  keep_scale, s)                            \
   : res ? backward<T, true, false>(x, res, keep, scale, g, du, dx,         \
                                    partial, dscale, dbias, rows, hidden,   \
                                    blocks, eps, keep_scale, s)             \
         : backward<T, false, false>(x, res, keep, scale, g, du, dx,        \
                                     partial, dscale, dbias, rows, hidden,  \
                                     blocks, eps, keep_scale, s))
  if (dtype == ldot::kFloat32) return LDOT_LN_BWD(float);
  if (dtype == ldot::kBFloat16) return LDOT_LN_BWD(__nv_bfloat16);
#undef LDOT_LN_BWD
  return cudaErrorInvalidValue;
}

// The RMS mode: out = x * rsqrt(mean(x^2) + eps) * scale, x and out
// [rows, hidden] as for ldot_layernorm, scale float32 [hidden].
extern "C" int ldot_rmsnorm(const void* x, const float* scale, void* out,
                            int rows, int hidden, float eps, int dtype,
                            void* stream) {
  if (!shape_ok(rows, hidden, nullptr, nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return forward<float, false, false, true>(x, nullptr, nullptr, scale,
                                              nullptr, out, rows, hidden,
                                              eps, 1.f, s);
  if (dtype == ldot::kBFloat16)
    return forward<__nv_bfloat16, false, false, true>(
        x, nullptr, nullptr, scale, nullptr, out, rows, hidden, eps, 1.f, s);
  return cudaErrorInvalidValue;
}

// The RMS mode's backward: dx in x's dtype, dscale float32 [hidden] summed
// through partial [blocks, 2 * hidden]; dbias_scratch [hidden] takes the
// unused bias column sums.
extern "C" int ldot_rmsnorm_bwd(const void* x, const float* scale,
                                const void* g, void* dx, float* partial,
                                float* dscale, float* dbias_scratch,
                                int rows, int hidden, int blocks, float eps,
                                int dtype, void* stream) {
  if (!shape_ok(rows, hidden, nullptr, nullptr) || blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ldot::kFloat32)
    return backward<float, false, false, true>(
        x, nullptr, nullptr, scale, g, dx, nullptr, partial, dscale,
        dbias_scratch, rows, hidden, blocks, eps, 1.f, s);
  if (dtype == ldot::kBFloat16)
    return backward<__nv_bfloat16, false, false, true>(
        x, nullptr, nullptr, scale, g, dx, nullptr, partial, dscale,
        dbias_scratch, rows, hidden, blocks, eps, 1.f, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ldot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
