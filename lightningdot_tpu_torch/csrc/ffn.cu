// float32 feed-forward block on the FMA units:
//   out = gelu(x W1 + b1) W2 + b2,  x [rows, H], W1 [H, I], W2 [I, H],
// and, for the backward, optionally h1 = x W1 + b1 (inter = gelu(h1)
// [rows, I] is written in any case); and the backward through the GELU:
//   dh1 = (g W2^T) * gelu'(h1),  g [rows, H], h1 [rows, I].
//
// Replaces, in float32, the TPU kernels lightningdot_tpu/ops/ffn.py::
// _ffn_kernel (:77; launched by _ffn_pallas, :122; with_h1 and with_inter
// under the default "store" policy when the training path needs a
// gradient) and lightningdot_tpu/ops/experimental/ffn_dh1.py::_dh1_kernel
// (:28, launched by dh1_pallas, :45); bfloat16 runs on the tensor cores
// (ffn_mma.cu, whose GEMM has the same three epilogues). float32 is what
// the cross-encoder teacher computes in (KD, re-ranking: every teacher
// layer, 106,880 rows a KD step), what training with --compute_dtype f32
// runs in every FFN layer (dh1 at 2,048 text and 4,096 image rows, 24
// launches a step), and the card-vs-CPU checks. TF32 stays out: it
// computes another function than the twin's float32, and Hopper has no
// other tensor-core path for float32.
//
// Rounding points, as the twins (ops/ffn.py::_ffn_math, ops/ffn_dh1.py::
// _dh1_math): every product accumulates in float32; h1 = (x W1) + b1, one
// rounding; inter = ldot::gelu_rounded<float>(h1), the erf GELU op by op
// (common.cuh, exact erff); out = (inter W2) + b2; dh1 = (g W2^T) times
// ldot::gelu_grad_rounded<float>(h1) (op by op, exact erff and expf; the
// TPU kernel's A&S erf polynomial existed only because Mosaic had no erf),
// one __fmul_rn. Only the order of the float32 sums differs from the twins
// (cuBLAS), so they are held within 1e-5 of them, not bit for bit.
//
// Bound: 4 rows H I flops (the FFN) and 2 rows H I (dh1) at 67 TFLOP/s:
// 15.05 ms at the KD teacher's 106,880 rows, 1.7-3.0 ms at a re-ranking
// block's 12,288-21,504; dh1 144.2 us at 2,048 rows and 288.5 at 4,096; at
// a few dozen rows the weights' 9.4-18.9 MB at 3.35 TB/s (2.8-5.6 us).
//
// Design: one float32 GEMM, C = A B with A [M, K] and B [K, N] row-major
// (the weights in their [in, out] layout), launched twice for the FFN as
// ffn_mma.cu's is: fc1 (A = x, B = W1), whose epilogue adds b1, writes h1
// when asked, applies GELU and writes inter; fc2 (A = inter, B = W2), whose
// epilogue adds b2. inter makes a device-memory round trip (2.6 GB at
// 106,880 rows, ~0.8 ms at 3.35 TB/s against the 15 ms bound): a 128-row
// tile of the 3,072-wide intermediate would not fit a block's shared
// memory. dh1 is fc1's shape with W2^T as B: transpose_b_kernel first
// writes W2^T [H, I] into a workspace (18.9 MB of traffic), then the GEMM
// (A = g, B = W2^T) runs with the dh1 epilogue, which reads h1 four floats
// at a time and writes dh1 once; dinter [rows, I] never reaches device
// memory.
// Reading W2 as stored instead, copied k-major one float at a time into
// shared memory as A is, was slower on an H100 80GB HBM3 at 700 W in a
// development comparison (not kept; medians of 5 in one call): 285.6 /
// 555.7 / 1,724.4 us at 2,048 / 4,096 / 13,312 rows against 271.0 / 516.6
// / 1,584.5 with the copy (its own time included), faster only at 16 rows
// (15.1 against 21.2 us) and level at 130.
// Within the GEMM: 128 x 128 output tiles of 256 threads, each thread an
// 8 x 8 register microtile (rows 4 ty + {0..3} and 64 + 4 ty + {0..3},
// columns 4 tx + {0..3} and 64 + 4 tx + {0..3}) filled by outer products:
// per k, two 128-bit shared loads of A and two of B feed 64 FMAs. A warp
// holds 4 ty x 8 tx, so its A loads read 64 contiguous bytes and its B
// loads 128: no bank conflicts. A 4-stage cp.async ring of k slices of 16
// (65 KB, so 2 blocks share an SM: 16 warps): A is copied one float at a
// time into k-major order, As[k][m] (rows padded by 4 floats, 16-byte
// aligned), B in 16-byte chunks as it lies, Bs[k][n]. The register budget
// is 128 a thread (__launch_bounds__(256, 2)); in development comparisons
// on an H100 (not kept), k slices of 8 or 32, 128 x 256 tiles of 8 x 16
// microtiles at one block an SM, and fragments double-buffered in
// registers were within 3 % of this at 106,880 rows; for dh1, 64 x 128
// tiles (4 x 8 microtiles, three blocks an SM) took 153.1 against 186.2 us
// at 1,024 rows but 280.2 against 271.0 at 2,048. Few rows take a
// narrow tile instead (narrow_kernel, 128 threads: 16 x 8 outputs, one a
// thread, or 32 x 32, 2 x 4 a thread), so that the grid still spreads
// over the card (fc2 at 32 rows: 192 blocks of 16 x 8, against 6 of 128 x
// 128); ops/gemm.py::f32_gemm_tile picks the tile from the measured
// crossings (scripts/perf_torch_f32_kernels.py), dh1's as fc1's. The
// reduction is never split: in any tile each output is one FMA chain over
// k = 0 .. K-1 in order, so a row's bits depend neither on the tile nor on
// how many rows share the launch. A split chosen by the row count, as the
// bf16 GEMM's, made two ranks of 32 rows and one process of 64 run
// different sums: chip_smoke's float32 two-ranks-vs-one-process loss read
// 1.07e-5 against its 1e-5 bound, and 6.4e-6 unsplit, on an H100. No
// atomics: a second launch gives the same bits. Ragged edges: rows and k
// past the end are zero by cp.async's zero fill, never written; H and I
// must be multiples of 4 (whole 16-byte chunks of rows and of the float4
// epilogue), every operand and output 16-byte aligned.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kStages = 4;
constexpr int kThreads = 256;                 // 16 x 16 threads of 8 x 8
constexpr int kLdA = kBM + 4;                 // As[k][m] row stride, floats
constexpr int kATile = kBK * kLdA;            // floats
constexpr int kBTile = kBK * kBN;             // floats
constexpr int kStageFloats = kATile + kBTile;
constexpr int kSmem = kStages * kStageFloats * 4;   // 66,560 bytes
static_assert(kBM * kBK % kThreads == 0 && kBK * kBN / 4 % kThreads == 0,
              "whole copy rounds");

enum Epilogue : int { kFc1 = 0, kFc2 = 1, kDh1 = 2 };

struct Gemm {
  const float* a;       // [m, k] row-major
  const float* b;       // [k, n] row-major
  const float* bias;    // [n]; null for dh1
  float* out;           // [m, n]: inter (fc1), the output (fc2) or dh1
  float* h1;            // [m, n]: written by fc1 when not null, read by dh1
  int m, n, k;
};

// 4 bytes global -> shared; ok = false reads nothing and writes a zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// the epilogue of columns col .. col + 3 of one row, from their float32 sums
template <int EPI>
__device__ __forceinline__ void finish(const Gemm& p, int row, int col,
                                       float4 s) {
  const size_t at = static_cast<size_t>(row) * p.n + col;
  if constexpr (EPI == kDh1) {
    const float4 h = *reinterpret_cast<const float4*>(p.h1 + at);
    *reinterpret_cast<float4*>(p.out + at) = make_float4(
        __fmul_rn(s.x, ldot::gelu_grad_rounded<float>(h.x)),
        __fmul_rn(s.y, ldot::gelu_grad_rounded<float>(h.y)),
        __fmul_rn(s.z, ldot::gelu_grad_rounded<float>(h.z)),
        __fmul_rn(s.w, ldot::gelu_grad_rounded<float>(h.w)));
    return;
  }
  const float4 y = make_float4(
      __fadd_rn(s.x, p.bias[col]), __fadd_rn(s.y, p.bias[col + 1]),
      __fadd_rn(s.z, p.bias[col + 2]), __fadd_rn(s.w, p.bias[col + 3]));
  if constexpr (EPI == kFc1) {
    if (p.h1 != nullptr) *reinterpret_cast<float4*>(p.h1 + at) = y;
    *reinterpret_cast<float4*>(p.out + at) = make_float4(
        ldot::gelu_rounded<float>(y.x), ldot::gelu_rounded<float>(y.y),
        ldot::gelu_rounded<float>(y.z), ldot::gelu_rounded<float>(y.w));
  } else {
    *reinterpret_cast<float4*>(p.out + at) = y;
  }
}

// the epilogue of one output, from its float32 sum
template <int EPI>
__device__ __forceinline__ void finish1(const Gemm& p, int row, int col,
                                        float s) {
  const size_t at = static_cast<size_t>(row) * p.n + col;
  if constexpr (EPI == kDh1) {
    p.out[at] = __fmul_rn(s, ldot::gelu_grad_rounded<float>(p.h1[at]));
    return;
  }
  const float y = __fadd_rn(s, p.bias[col]);
  if constexpr (EPI == kFc1) {
    if (p.h1 != nullptr) p.h1[at] = y;
    p.out[at] = ldot::gelu_rounded<float>(y);
  } else {
    p.out[at] = y;
  }
}

// block (blockIdx.x, blockIdx.y) = (column tile, row tile) of 128 x 128:
// every k slice, in order
template <int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(Gemm p) {
  extern __shared__ __align__(16) float smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int nkt = (p.k + kBK - 1) / kBK;

  auto load = [&](int kt, int slot) {
    const uint32_t sa = s0 + slot * kStageFloats * 4;
    const uint32_t sb = sa + kATile * 4;
    const int k0 = kt * kBK;
    // A: a warp copies 2 rows x 16 k (coalesced), stored k-major
#pragma unroll
    for (int it = 0; it < kBM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int row = m0 + r, kk = k0 + c;
      const bool ok = row < p.m && kk < p.k;
      cp_async4(sa + (c * kLdA + r) * 4,
                ok ? p.a + static_cast<size_t>(row) * p.k + kk : p.a, ok);
    }
    // B: 16 k rows of 32 16-byte chunks
#pragma unroll
    for (int it = 0; it < kBK * kBN / 4 / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int r = e / (kBN / 4), ch = e % (kBN / 4);
      const int kk = k0 + r, col = n0 + ch * 4;
      const bool ok = kk < p.k && col < p.n;
      ldot::cp_async16(sb + (r * kBN + ch * 4) * 4,
                       ok ? p.b + static_cast<size_t>(kk) * p.n + col : p.b,
                       ok);
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);   // 0..15
  const int tx = (warp & 1) * 8 + (lane & 7);     // 0..15
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) load(st, st);
    ldot::cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    ldot::cp_async_wait<kStages - 2>();
    __syncthreads();   // slice i landed; every warp is done with i - 1
    if (i + kStages - 1 < nkt)
      load(i + kStages - 1, (i + kStages - 1) % kStages);
    ldot::cp_async_commit();
    const float* as = smem + (i % kStages) * kStageFloats;
    const float* bs = as + kATile;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(as + kk * kLdA + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * kLdA + 64 + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + kk * kBN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * kBN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
  }
  ldot::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = m0 + (r & 4) * 16 + ty * 4 + (r & 3);
    if (row >= p.m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= p.n) continue;
      finish<EPI>(p, row, col,
                  make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                              acc[r][4 * h + 2], acc[r][4 * h + 3]));
    }
  }
}

// Few rows: 16 TM x 8 TN output tiles of 128 threads, thread (ty, tx) =
// (tid / 8, tid % 8) holding rows ty + 16 i (i < TM) by columns TN tx ..
// TN tx + TN - 1. Both operands are copied as they lie, in 16-byte chunks:
// As[m][k] (rows padded by 4 floats) and Bs[k][n]. Per 4 k, TM 128-bit
// loads of A and 4 of B (128-bit at TN 4, one float at TN 1) feed 4 TM TN
// FMAs; a warp's loads touch 4 rows of A and 8 TN contiguous floats of a
// row of B, conflict-free. A 4-stage cp.async ring of k slices of 64 at
// TN 1, 32 at TN 4. One output a thread (TM = TN = 1) puts the most
// threads on the few outputs of few rows; 2 x 4 loads less for more.
constexpr int kNThreads = 128;

template <int EPI, int TM, int TN>
__global__ void __launch_bounds__(kNThreads) narrow_kernel(Gemm p) {
  constexpr int BM = 16 * TM, BN = 8 * TN, BK = TN == 1 ? 64 : 32;
  constexpr int kLd = BK + 4;   // As[m][k] row stride, floats
  constexpr int kA = BM * kLd, kStage = kA + BK * BN;
  static_assert(BM * BK / 4 % kNThreads == 0 && BK * BN / 4 % kNThreads == 0,
                "whole copy rounds");
  __shared__ __align__(16) float smem[kStages * kStage];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nkt = (p.k + BK - 1) / BK;

  auto load = [&](int kt, int slot) {
    const uint32_t sa = s0 + slot * kStage * 4;
    const uint32_t sb = sa + kA * 4;
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < BM * BK / 4 / kNThreads; ++it) {
      const int e = tid + it * kNThreads;
      const int r = e / (BK / 4), ch = e % (BK / 4);
      const int row = m0 + r, kk = k0 + ch * 4;
      const bool ok = row < p.m && kk < p.k;
      ldot::cp_async16(sa + (r * kLd + ch * 4) * 4,
                       ok ? p.a + static_cast<size_t>(row) * p.k + kk : p.a,
                       ok);
    }
#pragma unroll
    for (int it = 0; it < BK * BN / 4 / kNThreads; ++it) {
      const int e = tid + it * kNThreads;
      const int r = e / (BN / 4), ch = e % (BN / 4);
      const int kk = k0 + r, col = n0 + ch * 4;
      const bool ok = kk < p.k && col < p.n;
      ldot::cp_async16(sb + (r * BN + ch * 4) * 4,
                       ok ? p.b + static_cast<size_t>(kk) * p.n + col : p.b,
                       ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) load(st, st);
    ldot::cp_async_commit();
  }
  for (int s = 0; s < nkt; ++s) {
    ldot::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < nkt)
      load(s + kStages - 1, (s + kStages - 1) % kStages);
    ldot::cp_async_commit();
    const float* as = smem + (s % kStages) * kStage;
    const float* bs = as + kA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a[TM][4], b[4][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            as + (ty + 16 * i) * kLd + kk);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* row = bs + (kk + q) * BN + tx * TN;
        if constexpr (TN == 4) {
          const float4 v = *reinterpret_cast<const float4*>(row);
          b[q][0] = v.x, b[q][1] = v.y, b[q][2] = v.z, b[q][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) b[q][j] = row[j];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
        }
      }
    }
  }
  ldot::cp_async_wait<0>();

  const int col = n0 + tx * TN;
  if (col >= p.n) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.m) continue;
    if constexpr (TN == 4) {
      finish<EPI>(p, row, col,
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) finish1<EPI>(p, row, col + j, acc[i][j]);
    }
  }
}

// dst [cols, rows] = src [rows, cols]^T through 32 x 32 shared tiles of
// 32 x 8 threads: a warp reads 128 contiguous bytes of a row of src and
// writes 128 of a row of dst; the tile's rows padded by one float
__global__ void __launch_bounds__(256)
    transpose_b_kernel(const float* __restrict__ src,
                       float* __restrict__ dst, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    if (r < rows && c < cols)
      tile[i][tx] = src[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows)
      dst[static_cast<size_t>(c) * rows + r] = tile[tx][i];
  }
}

// the output tiles, rows x cols, that a launch takes: 128 x 128
// (gemm_kernel), 16 x 8 and 32 x 32 (narrow_kernel)
bool tile_ok(int m, int rows, int cols) {
  return (rows == kBM && cols == kBN) || (rows == 16 && cols == 8) ||
                 (rows == 32 && cols == 32)
             ? (m + rows - 1) / rows <= 65535
             : false;
}

// one GEMM in output tiles of rows x cols (tile_ok)
template <int EPI>
cudaError_t run(const Gemm& p, int rows, int cols, cudaStream_t stream) {
  const dim3 grid((p.n + cols - 1) / cols, (p.m + rows - 1) / rows);
  if (rows == kBM) {
    static cudaError_t granted = cudaFuncSetAttribute(
        gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (granted != cudaSuccess) return granted;
    gemm_kernel<EPI><<<grid, kThreads, kSmem, stream>>>(p);
  } else if (rows == 16) {
    narrow_kernel<EPI, 1, 1><<<grid, kNThreads, 0, stream>>>(p);
  } else {
    narrow_kernel<EPI, 2, 4><<<grid, kNThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, H]; w1: [H, I]; w2: [I, H] (contiguous float32, 16-byte
// aligned); b1 [I], b2 [H] float32; inter: [rows, I]
// float32, always written (fc2 reads it), 16-byte aligned; h1: [rows, I]
// or null. rows1 x cols1, rows2 x cols2: fc1's and fc2's output tiles
// (ops/gemm.py::f32_gemm_tile). H % 4 == 0, I % 4 == 0.
extern "C" int ldot_ffn(const void* x, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, void* h1,
                        void* inter, int rows, int H, int I, int rows1,
                        int cols1, int rows2, int cols2, void* stream) {
  if (rows <= 0 || H <= 0 || I <= 0 || H % 4 != 0 || I % 4 != 0 ||
      !tile_ok(rows, rows1, cols1) || !tile_ok(rows, rows2, cols2) ||
      inter == nullptr || !ldot::aligned16(x) || !ldot::aligned16(w1) ||
      !ldot::aligned16(w2) ||
      !ldot::aligned16(out) || !ldot::aligned16(inter) ||
      (h1 != nullptr && !ldot::aligned16(h1)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gemm fc1{static_cast<const float*>(x), static_cast<const float*>(w1),
                 b1, static_cast<float*>(inter), static_cast<float*>(h1),
                 rows, I, H};
  cudaError_t err = run<kFc1>(fc1, rows1, cols1, s);
  if (err != cudaSuccess) return err;
  const Gemm fc2{static_cast<const float*>(inter),
                 static_cast<const float*>(w2), b2, static_cast<float*>(out),
                 nullptr, rows, H, I};
  return run<kFc2>(fc2, rows2, cols2, s);
}

// g: [rows, H]; h1, dh1: [rows, I]; w2: [I, H]; w2t: [H, I], a workspace
// into which W2^T is written first; all contiguous float32, 16-byte
// aligned. tile_rows x tile_cols: dh1's output tile (ops/gemm.py::
// f32_gemm_tile, as fc1's). H % 4 == 0, I % 4 == 0.
extern "C" int ldot_ffn_dh1(const void* g, const void* h1, const void* w2,
                            void* w2t, void* dh1, int rows, int H, int I,
                            int tile_rows, int tile_cols, void* stream) {
  if (rows <= 0 || H <= 0 || I <= 0 || H % 4 != 0 || I % 4 != 0 ||
      !tile_ok(rows, tile_rows, tile_cols) || !ldot::aligned16(g) ||
      !ldot::aligned16(h1) || !ldot::aligned16(w2) ||
      !ldot::aligned16(w2t) || !ldot::aligned16(dh1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  transpose_b_kernel<<<dim3((H + 31) / 32, (I + 31) / 32), 256, 0, s>>>(
      static_cast<const float*>(w2), static_cast<float*>(w2t), I, H);
  const Gemm p{static_cast<const float*>(g), static_cast<const float*>(w2t),
               nullptr, static_cast<float*>(dh1),
               const_cast<float*>(static_cast<const float*>(h1)), rows, I, H};
  return run<kDh1>(p, tile_rows, tile_cols, s);
}
