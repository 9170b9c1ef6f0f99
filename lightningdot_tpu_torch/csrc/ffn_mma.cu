// bfloat16 feed-forward block on the tensor cores:
//   out = gelu(x W1 + b1) W2 + b2,  x [rows, H], W1 [H, I], W2 [I, H],
// and, for the backward, optionally h1 = x W1 + b1 (inter = gelu(h1) is
// written in any case); and the backward's
//   dh1 = round(g W2^T) * gelu'(h1),  g [rows, H], h1 [rows, I].
//
// Replaces, in bfloat16, two TPU kernels: lightningdot_tpu/ops/ffn.py::
// _ffn_kernel (:77; launched by _ffn_pallas, :122), through ldot_ffn_mma
// below, which ops/ffn.py::ffn_cuda calls for bfloat16; and
// lightningdot_tpu/ops/experimental/ffn_dh1.py::_dh1_kernel (:28; launched
// by dh1_pallas), through ldot_ffn_dh1_mma, which ops/ffn_dh1.py::
// ffn_dh1_cuda calls for bfloat16. The float32 forms (the float32 teacher,
// training with --compute_dtype f32) stay on FMA kernels, ffn.cu and
// ffn_dh1.cu: the tensor cores have no float32 product.
//
// Rounding points, as the twins (ops/ffn.py::_ffn_math, ops/ffn_dh1.py::
// _dh1_math): h1 = round_bf16(x W1 + b1), the product summed in float32 and
// b1 added in float32; inter = ldot::gelu_rounded<bf16>(h1), op by op
// (common.cuh); out = round_bf16(inter W2 + b2); dh1 = round_bf16(
// round_bf16(g W2^T) * gelu_grad_rounded<bf16>(h1)), the product summed in
// float32. Only the order of the float32 sums differs from the twins.
//
// Bound: 4 rows H I flops on (2 H I + 2 rows H) bf16 values: at 2,048 rows
// and more the operations bound it (19.5 us at 2,048 rows, 127.0 at 13,312,
// at 989 TFLOP/s), at 32 rows the weights' 9.4 MB do (about 2.8 us at 3.35
// TB/s). dh1 is fc1's product, 2 rows H I flops (9.8 us at 2,048 rows),
// with h1 read and dh1 written (25 MB at 2,048 rows, 7.5 us).
//
// Design: one templated GEMM, C = A B with A [M, K] row-major and B [K, N]
// either row-major (the weights in their [in, out] layout: fc1, fc2) or
// given as [N, K] with K contiguous (W2 as stored, read as W2^T by dh1:
// the B layout is a template parameter, and no transposed copy is made),
// launched three ways: fc1 (A = x, B = W1), whose epilogue adds b1,
// rounds, writes h1 when asked, applies GELU and writes inter; fc2 (A =
// inter, B = W2), whose epilogue adds b2 and rounds; dh1 (A = g, B = W2 as
// [N = I][K = H]), whose epilogue reads h1 two columns at a time, applies
// gelu' and writes dh1, so that g W2^T never reaches device memory, as on
// the TPU. fc1 and fc2 are not fused through shared memory, as the TPU
// kernel kept the intermediate in VMEM: a 64-row tile of a 3,072-wide
// intermediate is 384 KB, beyond a block's 227 KB. inter goes through
// device memory (12.6 MB at 2,048 rows, which stays in the 50 MB L2 between
// the launches up to ~4,096 rows).
// Within the GEMM: 128 x 128 output tiles of 8 warps (2 x 4, each 64 x 32);
// a 3-stage cp.async ring of 128 x 64 A and 64 x 128 (or 128 x 64) B tiles
// (96 KB) in swizzled shared memory (mma.cuh), so 2 blocks share an SM;
// every product mma.sync m16n8k16, A by ldmatrix, B by ldmatrix.trans from
// [k][n] (as V in the attention forward's P V) or by ldmatrix from [n][k]
// (load_b_nk, as K in Q K^T). Few rows make too few tiles for 132 SMs, so
// the reduction is split (ops/gemm.py::gemm_plan chooses how far): each
// split writes its float32 partial sums to a workspace [splits, M, N] and a
// second pass sums them in split order and applies the epilogue. No
// atomics: the result does not depend on block scheduling (the
// served-vs-direct ranking check depends on it). Ragged edges: rows, K and
// N past the end are zero by cp.async's zero fill and never written; H and
// I must be multiples of 8 (whole 16-byte chunks). ptxas (-Xptxas -v,
// sm_90a, CUDA 12.8; the `resources` rows of chip_smoke.py): 124 registers
// for fc1 and fc2, 118 for dh1, no spills. Warps of 64 x 64 (4 per block,
// 212 registers) read less shared memory per product but were slower on an
// H100 at every row count in a development comparison (not kept): too few
// warps per SM. So was an epilogue staged in shared memory for 16-byte
// stores, except where h1 is written too. On an H100 the GEMM runs at
// 159-206 TFLOP/s (fc1 and fc2) and dh1 at 127-141 TFLOP/s (PERF.md): the
// 128 x 128 tiles re-read A and B from L2 for every output tile, and the
// epilogues' erf (GELU, gelu') costs about a fifth more. Not wgmma: mma.sync
// with the attention kernels' helpers first.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using Bf16 = __nv_bfloat16;
using ldot::cp_async16;
using ldot::cp_async_commit;
using ldot::cp_async_wait;
using ldot::round_to;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 256;                // 8 warps of 64 x 32
constexpr int kAChunks = kBK / 8;            // 16-byte chunks per A row
constexpr int kBChunks = kBN / 8;            // per B row, B as [k][n]
constexpr int kATile = kBM * kBK * 2;        // bytes
constexpr int kBTile = kBK * kBN * 2;        // either layout
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmem = kStages * kStageBytes;  // 96 KB
static_assert(kBM * kAChunks % kThreads == 0 &&
                  kBK * kBChunks % kThreads == 0 &&
                  kBN * kAChunks % kThreads == 0,
              "whole copy rounds");

enum Epilogue : int { kFc1 = 0, kFc2 = 1, kDh1 = 2 };
// how B lies in memory: [k][n] row-major (the weights in their [in, out]
// layout, as fc1 and fc2 read W1 and W2), or [n][k] with k contiguous (W2
// as stored, read as W2^T by dh1)
enum BLayout : int { kKN = 0, kNK = 1 };

struct Gemm {
  const Bf16* a;        // [m, k] row-major
  const Bf16* b;        // [k, n] row-major (kKN) or [n, k] (kNK)
  const float* bias;    // [n]; null for dh1
  Bf16* out;            // [m, n]: inter (fc1), the output (fc2) or dh1
  Bf16* h1;             // [m, n]: written by fc1 (or null), read by dh1
  float* ws;            // [splits, m, n] partial sums when split
  int m, n, k;
  int per;              // k tiles of kBK per split
};

__device__ __forceinline__ void store2(Bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// the epilogue of columns col, col + 1 of one row, from their float32 sums
template <int EPI>
__device__ __forceinline__ void finish(const Gemm& p, int row, int col,
                                       float x0, float x1) {
  const size_t at = static_cast<size_t>(row) * p.n + col;
  if constexpr (EPI == kDh1) {
    // dh1 = round(round(g W2^T) gelu'(h1)), as ffn_dh1.cu and the twin
    const __nv_bfloat162 h =
        *reinterpret_cast<const __nv_bfloat162*>(p.h1 + at);
    store2(p.out + at,
           __fmul_rn(round_to<Bf16>(x0),
                     ldot::gelu_grad_rounded<Bf16>(__low2float(h))),
           __fmul_rn(round_to<Bf16>(x1),
                     ldot::gelu_grad_rounded<Bf16>(__high2float(h))));
    return;
  }
  const float y0 = round_to<Bf16>(__fadd_rn(x0, p.bias[col]));
  const float y1 = round_to<Bf16>(__fadd_rn(x1, p.bias[col + 1]));
  if constexpr (EPI == kFc1) {
    if (p.h1 != nullptr) store2(p.h1 + at, y0, y1);
    store2(p.out + at, ldot::gelu_rounded<Bf16>(y0),
           ldot::gelu_rounded<Bf16>(y1));
  } else {
    store2(p.out + at, y0, y1);
  }
}

// block (blockIdx.x, blockIdx.y, blockIdx.z) = (column tile, row tile,
// split): k tiles [z per, min((z + 1) per, ceil(k / kBK)))
template <int EPI, int BL>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(Gemm p) {
  constexpr int kWarpsN = 4;
  constexpr int kNt = 4;                     // n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int kt0 = split * p.per;
  const int nkt = min(p.per, (p.k + kBK - 1) / kBK - kt0);

  auto load = [&](int kt, int slot) {
    const uint32_t sa = s0 + slot * kStageBytes;
    const uint32_t sb = sa + kATile;
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < kBM * kAChunks / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = c / kAChunks, ch = c % kAChunks;
      const int row = m0 + r, col = k0 + ch * 8;
      const bool ok = row < p.m && col < p.k;
      cp_async16(sa + ldot::swz<kAChunks>(r, ch),
                 ok ? p.a + static_cast<size_t>(row) * p.k + col : p.a, ok);
    }
    if constexpr (BL == kKN) {
#pragma unroll
      for (int it = 0; it < kBK * kBChunks / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int r = c / kBChunks, ch = c % kBChunks;
        const int kk = k0 + r, col = n0 + ch * 8;
        const bool ok = kk < p.k && col < p.n;
        cp_async16(sb + ldot::swz<kBChunks>(r, ch),
                   ok ? p.b + static_cast<size_t>(kk) * p.n + col : p.b, ok);
      }
    } else {   // [n][k] rows of kBK, staged as A is
#pragma unroll
      for (int it = 0; it < kBN * kAChunks / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int r = c / kAChunks, ch = c % kAChunks;
        const int col = n0 + r, kk = k0 + ch * 8;
        const bool ok = col < p.n && kk < p.k;
        cp_async16(sb + ldot::swz<kAChunks>(r, ch),
                   ok ? p.b + static_cast<size_t>(col) * p.k + kk : p.b, ok);
      }
    }
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * 64;     // the warp's 64 x 32 sub-tile
  const int wn = (warp % kWarpsN) * 32;
  // row blocks of 16 of the warp that hold rows (warp-uniform)
  const int mblocks = min(4, max(0, (p.m - m0 - wm + 15) / 16));
  float acc[4][kNt][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    }
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) load(kt0 + st, st);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i landed; every warp is done with tile i - 1
    if (i + kStages - 1 < nkt)
      load(kt0 + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t sa = s0 + (i % kStages) * kStageBytes;
    const uint32_t sb = sa + kATile;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[kNt / 2][4];
#pragma unroll
      for (int nj = 0; nj < kNt / 2; ++nj) {
        if constexpr (BL == kKN)
          ldot::load_b_kn<kBChunks>(bf[nj], sb, wn + 16 * nj, ks, lane);
        else
          ldot::load_b_nk<kAChunks>(bf[nj], sb, wn + 16 * nj, ks, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < mblocks) {
          uint32_t af[4];
          ldot::load_a<kAChunks>(af, sa, wm + 16 * mi, ks, lane);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            ldot::mma_bf16(acc[mi][nt], af, bf[nt >> 1][2 * (nt & 1)],
                           bf[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = n0 + wn + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm + 16 * mi + g + 8 * r;
        if (row >= p.m || col >= p.n) continue;
        const float x0 = acc[mi][nt][2 * r], x1 = acc[mi][nt][2 * r + 1];
        if (direct) {
          finish<EPI>(p, row, col, x0, x1);
        } else {
          *reinterpret_cast<float2*>(
              p.ws + (static_cast<size_t>(split) * p.m + row) * p.n + col) =
              make_float2(x0, x1);
        }
      }
    }
  }
}

// the split pass: each thread sums 4 neighbouring columns over the splits
// in split order, then applies the epilogue
template <int EPI>
__global__ void reduce_kernel(Gemm p, int splits) {
  const size_t mn = static_cast<size_t>(p.m) * p.n;
  for (size_t at = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
       at < mn; at += static_cast<size_t>(gridDim.x) * blockDim.x * 4) {
    float4 s = *reinterpret_cast<const float4*>(p.ws + at);
    for (int z = 1; z < splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(p.ws + z * mn + at);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int row = static_cast<int>(at / p.n);
    const int col = static_cast<int>(at % p.n);
    finish<EPI>(p, row, col, s.x, s.y);
    finish<EPI>(p, row, col + 2, s.z, s.w);
  }
}

template <int EPI, int BL>
cudaError_t run(const Gemm& p, int splits, cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      gemm_kernel<EPI, BL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (granted != cudaSuccess) return granted;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, splits);
  gemm_kernel<EPI, BL><<<grid, kThreads, kSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t quads = static_cast<size_t>(p.m) * p.n / 4;
  const int blocks = static_cast<int>(
      (quads + kThreads - 1) / kThreads < 4096 ? (quads + kThreads - 1) /
                                                     kThreads
                                               : 4096);
  reduce_kernel<EPI><<<blocks, kThreads, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

// a split plan covers every k tile once and leaves no split empty
bool plan_ok(int k, int splits, int per) {
  const int kt = (k + kBK - 1) / kBK;
  return splits >= 1 && per >= 1 && (splits - 1) * per < kt &&
         splits * per >= kt;
}

}  // namespace

// x, out: [rows, H]; w1: [H, I]; w2: [I, H] (contiguous bfloat16, 16-byte
// aligned); b1 [I], b2 [H] float32; inter: [rows, I] bfloat16, always
// written (fc2 reads it); h1: [rows, I] or null. workspace: float32 of
// max(splits1 * rows * I, splits2 * rows * H) when a GEMM is split (null
// otherwise). (splitsN, perN): fc1's and fc2's plans, k tiles of 64 per
// split (ops/ffn.py::gemm_plan). H % 8 == 0, I % 8 == 0.
extern "C" int ldot_ffn_mma(const void* x, const void* w1, const float* b1,
                            const void* w2, const float* b2, void* out,
                            void* h1, void* inter, float* workspace, int rows,
                            int H, int I, int splits1, int per1, int splits2,
                            int per2, void* stream) {
  if (rows <= 0 || H <= 0 || I <= 0 || H % 8 != 0 || I % 8 != 0 ||
      !plan_ok(H, splits1, per1) || !plan_ok(I, splits2, per2) ||
      ((splits1 > 1 || splits2 > 1) && workspace == nullptr) ||
      inter == nullptr || !ldot::aligned16(x) || !ldot::aligned16(w1) ||
      !ldot::aligned16(w2) || !ldot::aligned16(out) ||
      !ldot::aligned16(inter) || (h1 != nullptr && !ldot::aligned16(h1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gemm fc1{static_cast<const Bf16*>(x), static_cast<const Bf16*>(w1),
                 b1, static_cast<Bf16*>(inter), static_cast<Bf16*>(h1),
                 workspace, rows, I, H, per1};
  cudaError_t err = run<kFc1, kKN>(fc1, splits1, s);
  if (err != cudaSuccess) return err;
  const Gemm fc2{static_cast<const Bf16*>(inter),
                 static_cast<const Bf16*>(w2), b2, static_cast<Bf16*>(out),
                 nullptr, workspace, rows, H, I, per2};
  return run<kFc2, kKN>(fc2, splits2, s);
}

// dh1 = round(round(g W2^T) gelu'(h1)): g [rows, H], h1 and dh1 [rows, I],
// w2 [I, H] as stored (contiguous bfloat16, 16-byte aligned). workspace:
// float32 of splits * rows * I when split (null otherwise); (splits, per)
// the plan over H (ops/gemm.py::gemm_plan). H % 8 == 0, I % 8 == 0.
extern "C" int ldot_ffn_dh1_mma(const void* g, const void* h1, const void* w2,
                                void* dh1, float* workspace, int rows, int H,
                                int I, int splits, int per, void* stream) {
  if (rows <= 0 || H <= 0 || I <= 0 || H % 8 != 0 || I % 8 != 0 ||
      !plan_ok(H, splits, per) || (splits > 1 && workspace == nullptr) ||
      !ldot::aligned16(g) || !ldot::aligned16(h1) || !ldot::aligned16(w2) ||
      !ldot::aligned16(dh1))
    return cudaErrorInvalidValue;
  const Gemm p{static_cast<const Bf16*>(g), static_cast<const Bf16*>(w2),
               nullptr, static_cast<Bf16*>(dh1),
               const_cast<Bf16*>(static_cast<const Bf16*>(h1)), workspace,
               rows, I, H, per};
  return run<kDh1, kNK>(p, splits, static_cast<cudaStream_t>(stream));
}
