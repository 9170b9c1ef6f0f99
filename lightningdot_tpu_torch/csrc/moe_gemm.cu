// Grouped GEMMs of SwiGLU feed-forward blocks on the tensor cores, for the
// Moonlight (DeepSeek-V3) text tower's layers (models/moonlight.py): the
// routed experts a card holds, the shared experts and the dense layer, each
// a set of groups of rows that share one weight matrix:
//
//   forward   G, U = x W_gate^T, x W_up^T  (rows gathered from x)
//             act = silu(G) U              (the gate/up GEMM's epilogue)
//             Y = act W_down^T
//   backward  dact = dY W_down;  dG, dU from dact, G, U (its epilogue)
//             dx_rows = [dG | dU] W_gu
//             dW_down[g] = dY_g^T act_g;  dW_gu[g] = [dG | dU]_g^T x_g
//
// plus the routing's gathers: the weighted sum of each token's expert rows
// (ldot_moe_combine), the scaled copy of a token's cotangent to its rows
// (ldot_moe_scatter_rows) and the routing weights' gradient
// (ldot_moe_route_grad).
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. Added
// because a card of the 16-card deployment (benchmark/configs/
// lightningdot-moonlight-16b-a3b.json) holds 8 of each layer's 64 experts
// and must compute only its own experts' rows, with the rows per expert
// known only on the device (no host sync inside a layer).
//
// Groups: `offsets` [groups + 1] (int32, on the device) delimits each
// group's rows among the rows sorted by group. Row kinds (kRowsNK, kRowsKN)
// cut each group's rows into 128-row tiles; block (x, y) takes column tile
// x and the row tiles y, y + gridDim.y, ... of the tiles of all groups in
// turn (it counts them from `offsets` itself), so that a grid fixed on the
// host covers any split of the rows. The weight kind (kWeights) gives a
// group's weight gradient: block (x, y, g) sums over group g's rows.
// No atomics: every output is one block's, in a fixed order.
//
// Bound: 2 rows H I flops for each of the three products at bf16 rates.
// At the held experts' ~700 rows an expert (batch 512) each weight matrix
// (5.8 MB bf16) is read about once per 6 row tiles, so the operations bound
// it; a tile of few rows in a group's tail is the main loss.
//
// Design: ffn_mma.cu's GEMM (128 x 128 tiles of 8 warps of 64 x 32, a
// 3-stage cp.async ring of swizzled 64-deep tiles, mma.sync m16n8k16 via
// ldmatrix), with (a) A's rows read through a row map (x gathered by token
// without a copy), (b) the weight kind's A read transposed (ldmatrix.trans
// of a [k][m] tile) and B's rows through a map, (c) the gate/up GEMM's B
// tile staged as 8-row slices of W_gate and W_up in turn, so that each
// thread holds a gate and an up accumulator of the same element and the
// SwiGLU is its epilogue. Rounding points, as the twins (ops/moe.py): G, U,
// act, Y, dact, dG, dU, dx rows and weight gradients are each rounded to
// bf16 once from their float32 sums.
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
constexpr int kThreads = 256;                  // 8 warps of 64 x 32
constexpr int kTile = kBM * kBK * 2;           // bytes of any staged tile
constexpr int kStageBytes = 2 * kTile;
constexpr int kSmem = kStages * kStageBytes;   // 96 KB
constexpr int kMaxGroups = 64;
constexpr int kVec = 8;                        // bf16 a 16-byte vector

enum Kind : int {
  kRowsNK = 0,   // row groups, B[g] stored [n][k] (W as stored: forward)
  kRowsKN = 1,   // row groups, B[g] stored [k][n] (W as stored: backward)
  kWeights = 2,  // weight gradients: out[g] = A_g^T B_g over g's rows
};
enum Epi : int { kStore = 0, kSwiGLU = 1, kSwiGLUBwd = 2 };

struct Args {
  const Bf16* a;        // rows kinds [*, k] (rows by a_map); kWeights [*, m]
  const int* a_map;     // rows kinds: A's row of each sorted row, or null
  const Bf16* b;        // the groups' weights, or kWeights' [*, n]
  const int* b_map;     // kWeights: B's row of each sorted row, or null
  const int* offsets;   // [groups + 1]
  int groups;
  Bf16* out;            // kStore: [rows, n] (kWeights [groups, m, n]);
                        // kSwiGLU: G; kSwiGLUBwd: dGU [rows, 2 n]
  Bf16* out2;           // kSwiGLU: U
  Bf16* out3;           // kSwiGLU: act
  const Bf16* g_in;     // kSwiGLUBwd: G [rows, n]
  const Bf16* u_in;     // kSwiGLUBwd: U [rows, n]
  int m, n, k;          // kWeights: out [m, n]; rows kinds: out columns n,
                        // depth k
};

__device__ __forceinline__ void store2(Bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A fragment of 16 rows (m) x 16 k from a tile staged [k][m] (m
// contiguous, kChunks chunks a k row): the transposed load of load_a
template <int kChunks>
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4], uint32_t tile,
                                          int m0, int ks, int lane) {
  const int q = lane >> 3;
  ldot::ldsm_x4_trans(a, tile + ldot::swz<kChunks>(
                                    16 * ks + (lane & 7) + ((q >> 1) << 3),
                                    (m0 >> 3) + (q & 1)));
}

template <int KIND, int EPI>
struct Tile {
  static constexpr int kCols = EPI == kSwiGLU ? kBN / 2 : kBN;  // out cols
};

// one output tile: rows [row0, row_end) of group g (rows kinds) or m rows
// [m0, m0 + kBM) summed over k rows [row0, row_end) (kWeights)
template <int KIND, int EPI>
__device__ void tile(const Args& p, uint32_t s0, int g, int row0,
                     int row_end, int m0, int n0) {
  constexpr int kAChunks = KIND == kWeights ? kBM / 8 : kBK / 8;
  constexpr int kBChunks = KIND == kRowsNK ? kBK / 8 : kBN / 8;
  constexpr int kWarpsN = 4;
  constexpr int kNt = 4;
  const int tid = threadIdx.x;
  const Bf16* bg = p.b;
  if constexpr (KIND != kWeights) {
    const size_t per = EPI == kSwiGLU ? static_cast<size_t>(2) * p.n * p.k
                                      : static_cast<size_t>(p.n) * p.k;
    bg = p.b + static_cast<size_t>(g) * per;
  }
  // the A rows this thread copies (rows kinds): rows tid / 8 + 32 it
  const Bf16* arow[4];
  bool aok[4];
  if constexpr (KIND != kWeights) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = row0 + tid / kAChunks + 32 * it;
      aok[it] = r < row_end;
      const int src = aok[it] ? (p.a_map ? p.a_map[r] : r) : 0;
      arow[it] = p.a + static_cast<size_t>(src) * p.k;
    }
  }
  const int depth = KIND == kWeights ? row_end - row0 : p.k;
  const int nkt = (depth + kBK - 1) / kBK;

  auto load = [&](int kt, int slot) {
    const uint32_t sa = s0 + slot * kStageBytes;
    const uint32_t sb = sa + kTile;
    const int k0 = kt * kBK;
    if constexpr (KIND == kWeights) {
      // A^T: k rows of [*, m], staged [k][m]
#pragma unroll
      for (int it = 0; it < kBK * kAChunks / kThreads; ++it) {
        const int c = tid + it * kThreads;
        const int r = c / kAChunks, ch = c % kAChunks;
        const int kk = row0 + k0 + r, col = m0 + ch * 8;
        const bool ok = kk < row_end && col < p.m;
        cp_async16(sa + ldot::swz<kAChunks>(r, ch),
                   ok ? p.a + static_cast<size_t>(kk) * p.m + col : p.a, ok);
      }
      // B: k rows of [*, n] through b_map, staged [k][n]
#pragma unroll
      for (int it = 0; it < kBK * kBChunks / kThreads; ++it) {
        const int c = tid + it * kThreads;
        const int r = c / kBChunks, ch = c % kBChunks;
        const int kk = row0 + k0 + r, col = n0 + ch * 8;
        const bool ok = kk < row_end && col < p.n;
        const int src = ok ? (p.b_map ? p.b_map[kk] : kk) : 0;
        cp_async16(sb + ldot::swz<kBChunks>(r, ch),
                   ok ? p.b + static_cast<size_t>(src) * p.n + col : p.b, ok);
      }
    } else {
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int ch = tid % kAChunks;
        const int r = tid / kAChunks + 32 * it;
        const int col = k0 + ch * 8;
        const bool ok = aok[it] && col < p.k;
        cp_async16(sa + ldot::swz<kAChunks>(r, ch),
                   ok ? arow[it] + col : p.a, ok);
      }
      if constexpr (KIND == kRowsNK) {
#pragma unroll
        for (int it = 0; it < kBN * kBChunks / kThreads; ++it) {
          const int c = tid + it * kThreads;
          const int r = c / kBChunks, ch = c % kBChunks;
          const int kk = k0 + ch * 8;
          int wrow, col;
          if constexpr (EPI == kSwiGLU) {
            // 8-row slices of W_gate and W_up in turn
            const int q = r >> 3;
            col = n0 + (q >> 1) * 8 + (r & 7);
            wrow = ((q & 1) ? p.n : 0) + col;
          } else {
            col = n0 + r;
            wrow = col;
          }
          const bool ok = col < p.n && kk < p.k;
          cp_async16(sb + ldot::swz<kBChunks>(r, ch),
                     ok ? bg + static_cast<size_t>(wrow) * p.k + kk : bg, ok);
        }
      } else {
#pragma unroll
        for (int it = 0; it < kBK * kBChunks / kThreads; ++it) {
          const int c = tid + it * kThreads;
          const int r = c / kBChunks, ch = c % kBChunks;
          const int kk = k0 + r, col = n0 + ch * 8;
          const bool ok = kk < p.k && col < p.n;
          cp_async16(sb + ldot::swz<kBChunks>(r, ch),
                     ok ? bg + static_cast<size_t>(kk) * p.n + col : bg, ok);
        }
      }
    }
  };

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp / kWarpsN) * 64;
  const int wn = (warp % kWarpsN) * 32;
  const int mblocks =
      KIND == kWeights ? min(4, max(0, (p.m - m0 - wm + 15) / 16))
                       : min(4, max(0, (row_end - row0 - wm + 15) / 16));
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
    if (st < nkt) load(st, st);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < nkt)
      load(i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t sa = s0 + (i % kStages) * kStageBytes;
    const uint32_t sb = sa + kTile;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[kNt / 2][4];
#pragma unroll
      for (int nj = 0; nj < kNt / 2; ++nj) {
        if constexpr (KIND == kRowsNK)
          ldot::load_b_nk<kBChunks>(bf[nj], sb, wn + 16 * nj, ks, lane);
        else
          ldot::load_b_kn<kBChunks>(bf[nj], sb, wn + 16 * nj, ks, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < mblocks) {
          uint32_t af[4];
          if constexpr (KIND == kWeights)
            load_a_km<kAChunks>(af, sa, wm + 16 * mi, ks, lane);
          else
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

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = (KIND == kWeights ? m0 : row0) + wm + 16 * mi + gq +
                      8 * r;
      if (row >= (KIND == kWeights ? p.m : row_end)) continue;
      if constexpr (EPI == kSwiGLU) {
#pragma unroll
        for (int np = 0; np < kNt / 2; ++np) {
          const int col = n0 + (wn / 16 + np) * 8 + 2 * t;
          if (col >= p.n) continue;
          const size_t at = static_cast<size_t>(row) * p.n + col;
          float gv[2], uv[2], av[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            gv[e] = round_to<Bf16>(acc[mi][2 * np][2 * r + e]);
            uv[e] = round_to<Bf16>(acc[mi][2 * np + 1][2 * r + e]);
            av[e] = gv[e] * sigmoidf(gv[e]) * uv[e];
          }
          store2(p.out + at, gv[0], gv[1]);
          store2(p.out2 + at, uv[0], uv[1]);
          store2(p.out3 + at, av[0], av[1]);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = n0 + wn + 8 * nt + 2 * t;
          if (col >= p.n) continue;
          const float x0 = acc[mi][nt][2 * r], x1 = acc[mi][nt][2 * r + 1];
          if constexpr (EPI == kSwiGLUBwd) {
            const size_t at = static_cast<size_t>(row) * p.n + col;
            const float2 gg = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.g_in + at));
            const float2 uu = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.u_in + at));
            const float gv[2] = {gg.x, gg.y}, uv[2] = {uu.x, uu.y};
            const float da[2] = {round_to<Bf16>(x0), round_to<Bf16>(x1)};
            float dg[2], du[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = sigmoidf(gv[e]);
              dg[e] = da[e] * uv[e] * (s * (1.0f + gv[e] * (1.0f - s)));
              du[e] = da[e] * (gv[e] * s);
            }
            Bf16* o = p.out + static_cast<size_t>(row) * 2 * p.n + col;
            store2(o, dg[0], dg[1]);
            store2(o + p.n, du[0], du[1]);
          } else if constexpr (KIND == kWeights) {
            store2(p.out + (static_cast<size_t>(blockIdx.z) * p.m + row) *
                               p.n + col, x0, x1);
          } else {
            store2(p.out + static_cast<size_t>(row) * p.n + col, x0, x1);
          }
        }
      }
    }
  }
  __syncthreads();   // the ring is reused by the block's next tile
}

template <int KIND, int EPI>
__global__ void __launch_bounds__(kThreads, 2) grouped_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  __shared__ int s_off[kMaxGroups + 1], s_tiles[kMaxGroups + 1];
  if constexpr (KIND == kWeights) {
    const int g = blockIdx.z;
    tile<KIND, EPI>(p, s0, g, p.offsets[g], p.offsets[g + 1],
                    blockIdx.y * kBM, blockIdx.x * kBN);
    return;
  }
  if (threadIdx.x == 0) {
    int tiles = 0;
    for (int g = 0; g <= p.groups; ++g) {
      s_off[g] = p.offsets[g];
      s_tiles[g] = tiles;
      if (g < p.groups)
        tiles += (p.offsets[g + 1] - p.offsets[g] + kBM - 1) / kBM;
    }
  }
  __syncthreads();
  const int n0 = blockIdx.x * Tile<KIND, EPI>::kCols;
  int g = 0;
  for (int t = blockIdx.y; t < s_tiles[p.groups]; t += gridDim.y) {
    while (s_tiles[g + 1] <= t) ++g;
    const int row0 = s_off[g] + (t - s_tiles[g]) * kBM;
    tile<KIND, EPI>(p, s0, g, row0, s_off[g + 1], 0, n0);
  }
}

template <int KIND, int EPI>
cudaError_t launch(const Args& p, int grid_rows, cudaStream_t stream) {
  static cudaError_t granted = cudaFuncSetAttribute(
      grouped_kernel<KIND, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (granted != cudaSuccess) return granted;
  dim3 grid;
  if (KIND == kWeights)
    grid = dim3((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, p.groups);
  else
    grid = dim3((p.n + Tile<KIND, EPI>::kCols - 1) / Tile<KIND, EPI>::kCols,
                grid_rows, 1);
  grouped_kernel<KIND, EPI><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

__device__ __forceinline__ void load8(const Bf16* src, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(Bf16* dst, const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i],
                                                           f[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = r;
}

// out[t] = sum over slots k in order of w[t, k] y[pos[t, k]] (pos < 0:
// none; w null: 1), rounded once
__global__ void combine_kernel(const Bf16* __restrict__ y,
                               const int* __restrict__ pos,
                               const float* __restrict__ w, int topk,
                               Bf16* __restrict__ out, int tokens, int h) {
  const int nv = h / kVec;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(tokens) * nv;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int tok = static_cast<int>(i / nv), v = static_cast<int>(i % nv);
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < topk; ++k) {
      const int r = pos[tok * topk + k];
      if (r < 0) continue;
      const float wk = w ? w[tok * topk + k] : 1.0f;
      float f[kVec];
      load8(y + static_cast<size_t>(r) * h + v * kVec, f);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += wk * f[e];
    }
    store8(out + static_cast<size_t>(tok) * h + v * kVec, acc);
  }
}

// out[r] = w[order[r]] g[order[r] / topk] for the sorted rows r below
// offsets[groups], rounded once
__global__ void scatter_rows_kernel(const Bf16* __restrict__ g,
                                    const int* __restrict__ order,
                                    const float* __restrict__ w, int topk,
                                    const int* __restrict__ offsets,
                                    int groups, Bf16* __restrict__ out,
                                    int rows, int h) {
  const int total = min(offsets[groups], rows);
  const int nv = h / kVec;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < static_cast<size_t>(total) * nv;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / nv), v = static_cast<int>(i % nv);
    const int slot = order[r];
    const float wk = w[slot];
    float f[kVec];
    load8(g + static_cast<size_t>(slot / topk) * h + v * kVec, f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] *= wk;
    store8(out + static_cast<size_t>(r) * h + v * kVec, f);
  }
}

// dw[t, k] = g[t] . y[pos[t, k]] in float32 (0 where pos < 0): a warp a
// slot, lanes over 8-element vectors, then the warp's sum
__global__ void route_grad_kernel(const Bf16* __restrict__ g,
                                  const Bf16* __restrict__ y,
                                  const int* __restrict__ pos, int topk,
                                  float* __restrict__ dw, int tokens, int h) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  for (int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       s < tokens * topk; s += warps) {
    const int r = pos[s];
    float acc = 0.f;
    if (r >= 0) {
      const int tok = s / topk;
      for (int v = lane; v < h / kVec; v += 32) {
        float a[kVec], b[kVec];
        load8(g + static_cast<size_t>(tok) * h + v * kVec, a);
        load8(y + static_cast<size_t>(r) * h + v * kVec, b);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc += a[e] * b[e];
      }
    }
    acc = ldot::warp_sum(acc);
    if (lane == 0) dw[s] = acc;
  }
}

int blocks_for(size_t work, int threads) {
  const size_t b = (work + threads - 1) / threads;
  return static_cast<int>(b < 8192 ? (b > 0 ? b : 1) : 8192);
}

}  // namespace

// kind (Kind), epi (Epi): one grouped GEMM (see Args for each pointer's
// role); grid_rows: the row kinds' blocks along the row tiles (each takes
// every grid_rows-th tile). Every operand bfloat16, contiguous, 16-byte
// aligned; n and k (kWeights: m and n) multiples of 8; groups <= 64.
extern "C" int ldot_moe_gemm(int kind, int epi, const void* a,
                             const int* a_map, const void* b,
                             const int* b_map, const int* offsets, int groups,
                             void* out, void* out2, void* out3,
                             const void* g_in, const void* u_in, int m, int n,
                             int k, int grid_rows, void* stream) {
  if (groups <= 0 || groups > kMaxGroups || n <= 0 || n % 8 != 0 ||
      (kind != kWeights && (k <= 0 || k % 8 != 0 || grid_rows <= 0)) ||
      (kind == kWeights && (m <= 0 || m % 8 != 0)) || !ldot::aligned16(a) ||
      !ldot::aligned16(b) || !ldot::aligned16(out))
    return cudaErrorInvalidValue;
  const Args p{static_cast<const Bf16*>(a), a_map,
               static_cast<const Bf16*>(b), b_map, offsets, groups,
               static_cast<Bf16*>(out), static_cast<Bf16*>(out2),
               static_cast<Bf16*>(out3), static_cast<const Bf16*>(g_in),
               static_cast<const Bf16*>(u_in), m, n, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kRowsNK && epi == kSwiGLU) {
    if (!out2 || !out3) return cudaErrorInvalidValue;
    return launch<kRowsNK, kSwiGLU>(p, grid_rows, s);
  }
  if (kind == kRowsNK && epi == kStore)
    return launch<kRowsNK, kStore>(p, grid_rows, s);
  if (kind == kRowsKN && epi == kSwiGLUBwd) {
    if (!g_in || !u_in) return cudaErrorInvalidValue;
    return launch<kRowsKN, kSwiGLUBwd>(p, grid_rows, s);
  }
  if (kind == kRowsKN && epi == kStore)
    return launch<kRowsKN, kStore>(p, grid_rows, s);
  if (kind == kWeights && epi == kStore)
    return launch<kWeights, kStore>(p, 0, s);
  return cudaErrorInvalidValue;
}

// y: [rows, h]; pos, w: [tokens, topk] (w may be null); out: [tokens, h];
// h a multiple of 8, bfloat16 16-byte aligned
extern "C" int ldot_moe_combine(const void* y, const int* pos, const float* w,
                                int topk, void* out, int tokens, int h,
                                void* stream) {
  if (tokens <= 0 || h <= 0 || h % kVec || topk <= 0 ||
      !ldot::aligned16(y) || !ldot::aligned16(out))
    return cudaErrorInvalidValue;
  combine_kernel<<<blocks_for(static_cast<size_t>(tokens) * h / kVec, 256),
                   256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bf16*>(y), pos, w, topk, static_cast<Bf16*>(out),
      tokens, h);
  return cudaGetLastError();
}

// g: [tokens, h]; order: [rows] slot index (token * topk + k) of each
// sorted row; w: [tokens * topk]; out: [rows, h], rows below
// offsets[groups] written
extern "C" int ldot_moe_scatter_rows(const void* g, const int* order,
                                     const float* w, int topk,
                                     const int* offsets, int groups,
                                     void* out, int rows, int h,
                                     void* stream) {
  if (rows <= 0 || h <= 0 || h % kVec || topk <= 0 || groups <= 0 ||
      !ldot::aligned16(g) || !ldot::aligned16(out))
    return cudaErrorInvalidValue;
  scatter_rows_kernel<<<blocks_for(static_cast<size_t>(rows) * h / kVec,
                                   256),
                        256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bf16*>(g), order, w, topk, offsets, groups,
      static_cast<Bf16*>(out), rows, h);
  return cudaGetLastError();
}

// g: [tokens, h]; y: [rows, h]; pos: [tokens, topk]; dw: float32
// [tokens, topk]
extern "C" int ldot_moe_route_grad(const void* g, const void* y,
                                   const int* pos, int topk, float* dw,
                                   int tokens, int h, void* stream) {
  if (tokens <= 0 || h <= 0 || h % kVec || topk <= 0 ||
      !ldot::aligned16(g) || !ldot::aligned16(y))
    return cudaErrorInvalidValue;
  route_grad_kernel<<<blocks_for(static_cast<size_t>(tokens) * topk * 32,
                                 256),
                      256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Bf16*>(g), static_cast<const Bf16*>(y), pos, topk,
      dw, tokens, h);
  return cudaGetLastError();
}
