// Fused int8 feed-forward block of the int8 serving tower, forward only, on
// the tensor cores:
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
// (:24, launched by ffn_int8_pallas). Numerics follow the plain version,
// ops/ffn_int8.py::_ffn_int8_math (itself lightningdot_tpu/ops/ffn_int8.py::
// _ffn_int8_math with erf="exact"): scale = max(max|row|, 1e-8) * (1/127)
// (the float32 reciprocal multiply that XLA makes of "/ 127" under jit),
// round(v / scale) by IEEE division and rintf (half to even, as
// torch.round), clipped to +-127; exact int32 products; the dequant
// epilogue in the twin's order, acc * xs * s + b, with __fmul_rn/__fadd_rn
// so that nvcc cannot contract it into an FMA; GELU op by op in bf16
// (common.cuh, the bf16 FFN's code). int32 sums are exact in any order
// (|sum| <= 127^2 * I < 2^31 for I up to 133,000), so the result matches the
// twin bit for bit wherever the twin's own elementwise ops do, whatever the
// tiles and the split.
//
// Design. The requantization of the intermediate needs the max of a whole
// row of I = 3072 values, so fc2 cannot start before every fc1 column of the
// row exists: two GEMM launches, through device memory (the bf16
// intermediate, 12.6 MB at 2,048 rows, stays in the 50 MB L2).
//   1. fc1 (A = x, B = W1q^T), grid (column groups, row tiles of 64): each
//      block takes its rows' scales over all of H, quantizes its rows of x
//      once into shared memory (64 x H int8: 48 KB at H 768), then for each
//      128-column tile of its group streams W1q^T, applies the dequant
//      epilogue and GELU, writes the bf16 intermediate and each row's max
//      |g| over the tile's columns (tile_max). A group has as many tiles as
//      leave about two blocks per SM (ops/ffn_int8.py::ffn_int8_plan: 3 at
//      2,048 rows, 1 at few rows). fc1 never splits its reduction: its
//      epilogue needs whole sums.
//   2. fc2 (A = the intermediate, B = W2q^T), grid (H / 128, row tiles,
//      splits): each block reduces its rows' tile maxima to the row scale
//      (the max of the maxima is the row's max) and requantizes its k range
//      of the intermediate as it loads it, one k tile ahead of the
//      products: each thread holds the next tile's bf16 chunks in 16
//      registers while the warps multiply the current one, then quantizes
//      them into a second, double-buffered A tile. With one split it writes
//      the output; with several (few rows: ops/gemm.py::gemm_plan, about
//      one block per SM) its int32 partials go to a workspace [splits, rows,
//      H], and
//   3. a second pass sums them and applies the epilogue.
// So a call launches 2 kernels, 3 when fc2 splits, as the __dp4a kernels it
// replaces did: no separate quantization pass.
// Within a GEMM: 64 x 128 output tiles of 8 warps (2 x 4 of 32 x 32), k
// tiles of 128 int8 values (4 k32 steps), every product mma.sync m16n8k32
// s8 x s8 -> s32 (mma.cuh: mma_s8). B is the weights as stored, [n][k]
// with k contiguous, which is the .col operand as it lies: a 3-stage
// cp.async ring of 128 x 128-byte tiles, read by ldmatrix (load_b_nk: 8
// rows x 16 bytes = 16 int8 values, the same fragments as bf16 with k
// counted in bytes). A cannot go by cp.async, which cannot quantize: it is
// loaded as bf16 into registers, quantized, packed four to a word and
// stored in the same swizzled layout (load_a reads it unchanged).
// Quantization multiplies by the row's reciprocal scale and rounds by
// adding 1.5 2^23 (quant_fast), all on the FP32 pipes; the few values
// within 1e-4 of a rounding boundary are divided (quant), so every value is
// the IEEE division's.
//
// Bound: 4 rows H I int8 operations on 2 rows H bf16 values and 2 H I
// weight bytes. At 16-32 rows the 4.7 MB of int8 weights bound it (1.4
// us at 3.35 TB/s); at 2,048 rows the operations (9.8 us at 1,979 TOP/s).
// What holds it back on an H100 (PERF.md): quantizing A on load, once per
// value and column block, rows x I x H / 128 values in fc2 (37.7 M at 2,048
// rows) and rows x H x I / (128 x group) in fc1, at 8-10 FP32 instructions
// a value (an IEEE division each was slower); A read from L2 as bf16,
// twice the bytes of int8; fc1's erf GELU over rows x I values; and, at
// few rows, the chain of dependent loads of a block's k loop. Ragged edges:
// rows, k and columns past the end are zero and never written; H and I
// must be multiples of 16 (whole 16-byte chunks of int8), H at most 2,048.
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; the `resources` rows of
// chip_smoke.py): fc1 112 registers, fc2 128, the split pass 38, no
// spills; 2 blocks of 8 warps share an SM (96 KB and 64 KB of shared
// memory at H 768).
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using Bf16 = __nv_bfloat16;
using ldot::cp_async16;
using ldot::cp_async_commit;
using ldot::cp_async_wait;
using ldot::round_to;

constexpr int kBM = 64, kBN = 128, kBK = 128;    // kBK in int8 values
constexpr int kStages = 3;                       // the B ring
constexpr int kThreads = 256;                    // 8 warps of 32 x 32
constexpr int kWarpsN = 4;
constexpr int kMi = 2;                           // m16 blocks of a warp
constexpr int kNt = 4;                           // n8 tiles of a warp
constexpr int kChunks = kBK / 16;                // 16-byte chunks per row
constexpr int kATile = kBM * kBK;                // bytes: 8 KB
constexpr int kBTile = kBN * kBK;                // 16 KB
constexpr int kMaxKTiles = 16;                   // fc1 keeps all of A: H <= 2048
constexpr int kSmemMax = kMaxKTiles * kATile + kStages * kBTile;   // 176 KB
constexpr int kAPer = kBM * kBK / 8 / kThreads;  // bf16 chunks a thread
constexpr int kRowsPerWarp = kBM / (kThreads / 32);
constexpr float kInv127 = 1.0f / 127.0f;  // ops/ffn_int8.py: INV_127
static_assert(kBN * kChunks % kThreads == 0 &&
                  kBM * kBK / 8 % kThreads == 0 &&
                  kBM == 16 * kMi * (kThreads / 32 / kWarpsN) &&
                  kBN == 8 * kNt * kWarpsN,
              "whole copy rounds and warp tiles");

enum Epilogue : int { kFc1 = 0, kFc2 = 1 };

struct Gemm {
  const Bf16* a;        // [m, k] bfloat16, quantized per row on load
  const int8_t* b;      // [n, k] int8, k contiguous (the weights as stored)
  const float* s;       // [n] the weights' per-channel scales
  const float* bias;    // [n]
  Bf16* out;            // [m, n]: gelu(h1) (fc1) or the output (fc2)
  float* tile_max;      // [m, n_max]: max |gelu(h1)| of each row over each
                        // fc1 column tile; fc1 writes it, fc2 reads it
  float* row_scale;     // [m]: the intermediate's row scales (fc2 writes
                        // them for the split pass)
  int* ws;              // [splits, m, n] int32 partials (fc2, split)
  int m, n, k;
  int per;              // fc2: k tiles of kBK per split
  int cols;             // fc1: column tiles per block
  int n_max;            // fc1's column tiles
};

// round(v / scale) clipped to [-127, 127], as the twin's _quant_rows
__device__ __forceinline__ int quant(float v, float scale) {
  const float q = rintf(v / scale);
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

// quant() on the FP32 pipes alone, as the bits of a float whose low byte
// is the int8 value: v * inv, inv = 1 / scale rounded, is within 2^-15 of
// the true quotient, and the IEEE quotient within 2^-17 of it, so the two
// round to the same integer unless v * inv lies within 1e-4 of a
// half-integer;
// `near` flags those (about 1 value in 440, most of them quotients of two
// bf16 values that are exactly half-integers), for which quant() decides.
// Adding 1.5 2^23 rounds to an integer half to even, as rintf, and leaves
// it in the low mantissa bits (two's complement): no conversion
// instruction, which runs at an eighth of the FP32 rate. No clip either:
// for a row scaled by its own max, |v * inv| <= 127 (1 + 2^-22), which
// rounds to 127 at most
constexpr float kNearHalf = 0.5f - 1e-4f;
constexpr float kMagic = 12582912.0f;   // 1.5 * 2^23
__device__ __forceinline__ uint32_t quant_fast(float v, float inv,
                                               bool& near) {
  const float q = __fmul_rn(v, inv);
  const float t = __fadd_rn(q, kMagic);
  near = fabsf(__fsub_rn(q, __fsub_rn(t, kMagic))) > kNearHalf;
  return __float_as_uint(t);
}

// the low bytes of four words as one word, a in the lowest byte
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 8 bf16 values (one 16-byte chunk) as 8 int8 bytes in the same order,
// each quant(v, scale): by quant_fast, and by IEEE division for each value
// that lies near a rounding boundary
__device__ __forceinline__ uint2 quant8(const uint4& v, float scale,
                                        float inv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
  uint32_t q[8];
  bool near[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = quant_fast(f[i], inv, near[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (near[i]) q[i] = quant(f[i], scale);
  }
  return make_uint2(pack4(q[0], q[1], q[2], q[3]),
                    pack4(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ float absmax8(const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

// acc * xs * s + b in the twin's order, never contracted into an FMA
__device__ __forceinline__ float dequant(int acc, float xs, float s,
                                         float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), s), b);
}

__device__ __forceinline__ void store2(Bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// the block's row scales, max(max|row|, 1e-8) / 127, and their
// reciprocals: fc1 over x's whole row, fc2 over the row's fc1 tile maxima.
// Warp w takes rows 16 w .. 16 w + 15; every load is unconditional (rows
// past the end read the last row and count for nothing), so that the 16
// rows' loads are in flight together
template <int EPI>
__device__ __forceinline__ void row_scales(const Gemm& p, int m0,
                                           float* scale, float* inv) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;
  float mx[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = 0.f;
  if constexpr (EPI == kFc1) {
    for (int c = lane * 8; c < p.k; c += 32 * 8) {
      uint4 v[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        v[i] = *reinterpret_cast<const uint4*>(
            p.a + static_cast<size_t>(min(m0 + r0 + i, p.m - 1)) * p.k + c);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (m0 + r0 + i < p.m) mx[i] = fmaxf(mx[i], absmax8(v[i]));
    }
  } else {
    for (int c = lane; c < p.n_max; c += 32) {
      float v[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        v[i] = p.tile_max[static_cast<size_t>(min(m0 + r0 + i, p.m - 1)) *
                              p.n_max + c];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (m0 + r0 + i < p.m) mx[i] = fmaxf(mx[i], v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float s = fmaxf(ldot::warp_max(mx[i]), 1e-8f) * kInv127;
    const int row = m0 + r0 + i;
    if (lane == 0) {
      scale[r0 + i] = s;
      inv[r0 + i] = 1.0f / s;
      if (EPI == kFc2 && blockIdx.x == 0 && blockIdx.z == 0 && row < p.m)
        p.row_scale[row] = s;
    }
  }
}

// fc1: block (blockIdx.x, blockIdx.y) = (group of p.cols column tiles, row
// tile), all of k; its A, quantized once, stays in shared memory for the
// group. fc2: block (blockIdx.x, blockIdx.y, blockIdx.z) = (column tile,
// row tile, split), k tiles [z per, min((z + 1) per, ceil(k / kBK))), its A
// quantized tile by tile one k tile ahead of the products
template <int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(Gemm p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float scale[kBM], inv[kBM];     // the rows' scales, 1 / them
  __shared__ float red[kWarpsN][kBM];        // fc1's row maxima per warp
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int k_tiles = (p.k + kBK - 1) / kBK;
  // A: fc1 every k tile of the row tile, fc2 two slots; then the B ring
  const int a_slots = EPI == kFc1 ? k_tiles : 2;
  const uint32_t s_b = s0 + a_slots * kATile;
  const int m0 = blockIdx.y * kBM;

  // B tile (columns n0.., k tile kt) into ring slot `slot`
  auto fetch_b = [&](int n0, int kt, int slot) {
    const uint32_t sb = s_b + slot * kBTile;
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < kBN * kChunks / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = c / kChunks, ch = c % kChunks;
      const int col = n0 + r, kk = k0 + ch * 16;
      const bool ok = col < p.n && kk < p.k;
      cp_async16(sb + ldot::swz<kChunks>(r, ch),
                 ok ? p.b + static_cast<size_t>(col) * p.k + kk : p.b, ok);
    }
  };
  // A's k tile kt as bf16 chunks, into registers: thread chunk c = row c /
  // 16, values 8 (c % 16) .. + 7 of the tile; every load is unconditional
  // (an address clamped into the matrix), values past the end are zeroed
  auto fetch_a = [&](int kt, uint4 (&v)[kAPer]) {
#pragma unroll
    for (int it = 0; it < kAPer; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int row = m0 + (c >> 4);
      const int kk = kt * kBK + (c & 15) * 8;
      const uint4 x = *reinterpret_cast<const uint4*>(
          p.a + static_cast<size_t>(min(row, p.m - 1)) * p.k +
          min(kk, p.k - 8));
      v[it] = row < p.m && kk < p.k ? x : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // ... quantized by the row's scale into A slot `slot`: 8 bytes of int8
  // chunk (c % 16) / 2 (rows past the end: zeros, not quantized)
  auto stash_a = [&](int slot, const uint4 (&v)[kAPer]) {
#pragma unroll
    for (int it = 0; it < kAPer; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = c >> 4, j = c & 15;
      *reinterpret_cast<uint2*>(smem + slot * kATile +
                                ldot::swz<kChunks>(r, j >> 1) + (j & 1) * 8) =
          m0 + r < p.m ? quant8(v[it], scale[r], inv[r]) : make_uint2(0u, 0u);
    }
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * 16 * kMi;   // the warp's 32 x 32 tile
  const int wn = (warp % kWarpsN) * 8 * kNt;
  // row blocks of 16 of the warp that hold rows (warp-uniform)
  const int mblocks = min(kMi, max(0, (p.m - m0 - wm + 15) / 16));
  int acc[kMi][kNt][4];
  auto clear = [&]() {
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0;
      }
    }
  };
  // the four k32 steps of A slot sa and B slot sb
  auto multiply = [&](uint32_t sa, uint32_t sb) {
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t bf[kNt / 2][4];
#pragma unroll
      for (int nj = 0; nj < kNt / 2; ++nj)
        ldot::load_b_nk<kChunks>(bf[nj], sb, wn + 16 * nj, ks, lane);
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        if (mi < mblocks) {
          uint32_t af[4];
          ldot::load_a<kChunks>(af, sa, wm + 16 * mi, ks, lane);
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            ldot::mma_s8(acc[mi][nt], af, bf[nt >> 1][2 * (nt & 1)],
                         bf[nt >> 1][2 * (nt & 1) + 1]);
        }
      }
    }
  };
  clear();

  if constexpr (EPI == kFc1) {
    // the block's column tiles; the (column tile, k tile) steps stream B
    // through the ring, one step after another
    const int ct0 = blockIdx.x * p.cols;
    const int steps =
        (min(p.cols, (p.n + kBN - 1) / kBN - ct0)) * k_tiles;
    auto fetch_step = [&](int j) {
      fetch_b((ct0 + j / k_tiles) * kBN, j % k_tiles, j % kStages);
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < steps) fetch_step(st);
      cp_async_commit();
    }
    row_scales<EPI>(p, m0, scale, inv);
    __syncthreads();   // the scales, before any thread quantizes with them
    // all of A, quantized once: tile kt + 1 loads while tile kt is stored
    uint4 va[kAPer], vb[kAPer];
    fetch_a(0, va);
    for (int kt = 0; kt < k_tiles; kt += 2) {
      if (kt + 1 < k_tiles) fetch_a(kt + 1, vb);
      stash_a(kt, va);
      if (kt + 1 < k_tiles) {
        if (kt + 2 < k_tiles) fetch_a(kt + 2, va);
        stash_a(kt + 1, vb);
      }
    }
    for (int j = 0; j < steps; ++j) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // step j landed (and all of A); step j - 1 done
      if (j + kStages - 1 < steps) fetch_step(j + kStages - 1);
      cp_async_commit();
      const int kt = j % k_tiles;
      multiply(s0 + kt * kATile, s_b + (j % kStages) * kBTile);
      if (kt < k_tiles - 1) continue;
      // a column tile is whole: the dequant-GELU epilogue, the row maxima
      const int n0 = (ct0 + j / k_tiles) * kBN;
      float mx[kMi][2] = {};
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        if (mi >= mblocks) continue;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = n0 + wn + 8 * nt + 2 * t;
          if (col >= p.n) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rl = wm + 16 * mi + g + 8 * r;
            const float g0 = ldot::gelu_rounded<Bf16>(round_to<Bf16>(
                dequant(acc[mi][nt][2 * r], scale[rl], p.s[col],
                        p.bias[col])));
            const float g1 = ldot::gelu_rounded<Bf16>(round_to<Bf16>(
                dequant(acc[mi][nt][2 * r + 1], scale[rl], p.s[col + 1],
                        p.bias[col + 1])));
            mx[mi][r] = fmaxf(mx[mi][r], fmaxf(fabsf(g0), fabsf(g1)));
            if (m0 + rl < p.m)
              store2(p.out + static_cast<size_t>(m0 + rl) * p.n + col, g0,
                     g1);
          }
        }
      }
      clear();
      // the 4 lanes of a row, then the 4 warps of a row block; red is
      // rewritten only after the next step's barrier
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float m = mx[mi][r];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          if (t == 0) red[warp % kWarpsN][wm + 16 * mi + g + 8 * r] = m;
        }
      }
      __syncthreads();
      const int row = m0 + threadIdx.x;
      if (threadIdx.x < kBM && row < p.m) {
        float m = red[0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarpsN; ++w) m = fmaxf(m, red[w][threadIdx.x]);
        p.tile_max[static_cast<size_t>(row) * p.n_max + n0 / kBN] = m;
      }
    }
    cp_async_wait<0>();
  } else {
    const int n0 = blockIdx.x * kBN;
    const int split = blockIdx.z;
    const int kt0 = split * p.per;
    const int nkt = min(p.per, k_tiles - kt0);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nkt) fetch_b(n0, kt0 + st, st);
      cp_async_commit();
    }
    row_scales<EPI>(p, m0, scale, inv);
    __syncthreads();   // the scales, before any thread quantizes with them
    // A runs one k tile ahead of the products in registers: iteration i
    // quantizes tile i + 1, loaded during iteration i - 1, into the slot
    // that tile i - 1 used, and loads tile i + 2
    uint4 v[kAPer];
    if (nkt > 0) {
      fetch_a(kt0, v);
      stash_a(0, v);
      if (nkt > 1) fetch_a(kt0 + 1, v);
    }
    for (int i = 0; i < nkt; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tiles i landed; every warp is done with i - 1
      if (i + kStages - 1 < nkt)
        fetch_b(n0, kt0 + i + kStages - 1, (i + kStages - 1) % kStages);
      cp_async_commit();
      if (i + 1 < nkt) {
        stash_a((i + 1) & 1, v);
        if (i + 2 < nkt) fetch_a(kt0 + i + 2, v);
      }
      multiply(s0 + (i & 1) * kATile, s_b + (i % kStages) * kBTile);
    }
    cp_async_wait<0>();

    const bool direct = gridDim.z == 1;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      if (mi >= mblocks) continue;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = n0 + wn + 8 * nt + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int rl = wm + 16 * mi + g + 8 * r;
          const int row = m0 + rl;
          if (row >= p.m || col >= p.n) continue;
          const int a0 = acc[mi][nt][2 * r], a1 = acc[mi][nt][2 * r + 1];
          if (direct) {
            store2(p.out + static_cast<size_t>(row) * p.n + col,
                   dequant(a0, scale[rl], p.s[col], p.bias[col]),
                   dequant(a1, scale[rl], p.s[col + 1], p.bias[col + 1]));
          } else {
            *reinterpret_cast<int2*>(
                p.ws + (static_cast<size_t>(split) * p.m + row) * p.n +
                col) = make_int2(a0, a1);
          }
        }
      }
    }
  }
}

// fc2's split pass: each thread sums 4 neighbouring columns' int32
// partials over the splits, then applies the epilogue
__global__ void reduce_kernel(Gemm p, int splits) {
  const size_t mn = static_cast<size_t>(p.m) * p.n;
  for (size_t at = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) * 4;
       at < mn; at += static_cast<size_t>(gridDim.x) * blockDim.x * 4) {
    int4 s = *reinterpret_cast<const int4*>(p.ws + at);
    for (int z = 1; z < splits; ++z) {
      const int4 v = *reinterpret_cast<const int4*>(p.ws + z * mn + at);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int row = static_cast<int>(at / p.n);
    const int col = static_cast<int>(at % p.n);
    const float rs = p.row_scale[row];
    store2(p.out + at, dequant(s.x, rs, p.s[col], p.bias[col]),
           dequant(s.y, rs, p.s[col + 1], p.bias[col + 1]));
    store2(p.out + at + 2, dequant(s.z, rs, p.s[col + 2], p.bias[col + 2]),
           dequant(s.w, rs, p.s[col + 3], p.bias[col + 3]));
  }
}

template <int EPI>
cudaError_t run(const Gemm& p, int splits, cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
  if (granted != cudaSuccess) return granted;
  const int k_tiles = (p.k + kBK - 1) / kBK;
  const int col_tiles = (p.n + kBN - 1) / kBN;
  const dim3 grid(EPI == kFc1 ? (col_tiles + p.cols - 1) / p.cols
                              : col_tiles,
                  (p.m + kBM - 1) / kBM, splits);
  const int smem = (EPI == kFc1 ? k_tiles : 2) * kATile + kStages * kBTile;
  gemm_kernel<EPI><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t quads = static_cast<size_t>(p.m) * p.n / 4;
  const int blocks = static_cast<int>(
      (quads + kThreads - 1) / kThreads < 4096 ? (quads + kThreads - 1) /
                                                     kThreads
                                               : 4096);
  reduce_kernel<<<blocks, kThreads, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

// a split plan covers every k tile once and leaves no split empty
bool plan_ok(int k, int splits, int per) {
  const int kt = (k + kBK - 1) / kBK;
  return splits >= 1 && per >= 1 && (splits - 1) * per < kt &&
         splits * per >= kt;
}

}  // namespace

// x, out: [rows, H] bfloat16; w1t: [I, H] and w2t: [H, I] int8 (the
// quantized kernels, out-major); s1, b1: [I], s2, b2: [H] float32.
// Scratch: inter bfloat16 [rows, I]; tile_max float32 [rows, ceil(I /
// 128)]; row_scale float32 [rows]; workspace int32 [splits, rows, H] when
// splits > 1 (null otherwise). cols: fc1's column tiles per block;
// (splits, per): fc2's plan over I, k tiles of 128 (ops/ffn_int8.py::
// ffn_int8_plan). H % 16 == 0, H <= 2048, I % 16 == 0; x, w1t, w2t, inter
// and out 16-byte aligned.
extern "C" int ldot_ffn_int8(const void* x, const void* w1t, const float* s1,
                             const float* b1, const void* w2t,
                             const float* s2, const float* b2, void* out,
                             void* inter, float* tile_max, float* row_scale,
                             int* workspace, int rows, int H, int I,
                             int cols, int splits, int per, void* stream) {
  if (rows <= 0 || H <= 0 || I <= 0 || H % 16 != 0 ||
      H > kMaxKTiles * kBK || I % 16 != 0 || cols < 1 ||
      !plan_ok(I, splits, per) || (splits > 1 && workspace == nullptr) ||
      !ldot::aligned16(x) || !ldot::aligned16(w1t) || !ldot::aligned16(w2t) ||
      !ldot::aligned16(inter) || !ldot::aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_max = (I + kBN - 1) / kBN;
  const Gemm fc1{static_cast<const Bf16*>(x), static_cast<const int8_t*>(w1t),
                 s1, b1, static_cast<Bf16*>(inter), tile_max, nullptr,
                 nullptr, rows, I, H, 0, cols, n_max};
  cudaError_t err = run<kFc1>(fc1, 1, s);
  if (err != cudaSuccess) return err;
  const Gemm fc2{static_cast<const Bf16*>(inter),
                 static_cast<const int8_t*>(w2t), s2, b2,
                 static_cast<Bf16*>(out), tile_max, row_scale, workspace,
                 rows, H, I, per, 0, n_max};
  return run<kFc2>(fc2, splits, s);
}
