// Multi-head latent attention's attention core (DeepSeek-V3, arXiv
// 2412.19437; the Moonlight text tower, models/moonlight.py), forward and
// backward, in bfloat16 on the tensor cores:
//
//   s = q k^T * scale, over the keys j that are real (key_ok) and, when
//       causal, j <= i; p = softmax(s); o = p v; lse = log sum exp(s)
//
// for each real query i; a query that is not a real token (key_ok 0:
// padding) reads nothing: its o is 0, its lse +inf, and its gradients 0,
// so that the work follows the real tokens, not the padded length
//
// with q, k [B, S, heads, DQK] (DQK 192: 128 without RoPE and 64 with it,
// the RoPE part of k one head's, broadcast by the caller) and v
// [B, S, heads, DV] (DV 128): the query/key width and the value width
// differ, which csrc/attention*.cu (head dim <= 64, one width, no causal
// mask) do not take. The widths are template parameters, instantiated for
// Moonlight's (192, 128); bfloat16 only (float32 stays on the twins,
// ops/mla_attention.py).
//
// Replaces no TPU kernel: the JAX package's towers are BERT's. Bound: a
// head's work is 16 x S x (DQK + DV) operations a query tile against
// (2 DQK + 2 DV) bytes a row, far below the card's ridge, so device memory
// bounds it. At the text tower's [512 x 16 heads, S 32], counting whole
// padded tensors (as chip_smoke.py's rows and the benchmark's
// mla_attention_roofline do): q, k, v read and o written, 335 MB, 100.2 us
// forward at 3.35 TB/s; the backward's reads and writes, 604 MB, 180.3 us.
// Counting the bytes this kernel moves, at the captions' 13.9 real tokens
// of 32: the real rows of q, k, v (and o, dO, lse) read, every row of o,
// lse (and dq, dk, dv) written, padding as zeros: 185 MB, 55.2 us forward;
// 444 MB, 132.4 us backward.
//
// Design: one block per (sequence, head), one warp per 16-row tile
// (S / 16 warps, rounded up). The head's real rows of q, k and v (and, in
// the backward, dO) are staged in shared memory as bf16 by 16-byte
// cp.async, rows that are not real tokens zero-filled without a read, only
// up to the tile of the last real token: 1,024 bytes a padded row forward
// (32 KB at S 32, so 6 blocks of 2 warps an SM keep the loads of 6 heads in
// flight), 1,280 bytes backward plus P and dS (50 KB at S 32: 4 blocks).
// Each 16-byte chunk of a staged row is permuted by row % 8 (mma.cuh's
// swz), so ldmatrix reads are free of bank conflicts. Products are mma.sync
// m16n8k16, bf16 operands and float32 sums; key tiles past the last real
// token, and past the query tile under the causal mask, are skipped.
//   Forward: a warp scores its 16 queries against the key tiles (12 k16
//   steps over DQK), takes the softmax in registers (a row on a quad of
//   lanes, shuffles 1 and 2), writes lse = max + log(sum) and forms
//   p = exp(s - lse) as the twin does; o = p v with p entering as a hi/lo
//   pair, hi = bf16(p), lo = bf16(p - hi), two products into the same
//   float32 sums, so p keeps the twin's float32 precision to ~2^-17.
//   Backward: phase 1, a warp per query tile: s and p again from lse,
//   dp = dO v^T, D = rowsum(dO o) (o from device memory, dO from shared
//   memory), ds = p (dp - D); P and dS written to shared memory as hi/lo
//   pairs; dq = ds k * scale from the registers. Phase 2, after a barrier,
//   a warp per key tile: dv = P^T dO and dk = dS^T q * scale, P^T and dS^T
//   by ldmatrix.trans. One block owns the whole head (S <= 64), so every
//   sum is one warp's in a fixed order: no atomics, and a launch repeats
//   its bits.
// Tiles with no real token write their rows of o, lse (dq, dk, dv) as zeros
// (+inf) by 16-byte stores; every other row is written from its
// accumulators, padding's as exact zeros. S <= 64 (the text rungs of the
// tower's captions); a longer sequence raises in the wrapper.
#include <cstdint>
#include <initializer_list>

#include "mma.cuh"

namespace {

constexpr int kMaxSeq = 64;
constexpr unsigned kFull = 0xffffffffu;

using Bf16 = __nv_bfloat16;
using ldot::mma_bf16;

__host__ __device__ __forceinline__ int padded(int seq) {
  return (seq + 15) / 16 * 16;
}

// bytes of a row of the staged P / dS tiles ([S][S] bf16): an odd number
// of 16-byte chunks, so the 8 rows of an ldmatrix matrix (and of a quad's
// stores) fall in 8 distinct groups of 4 banks
__host__ __device__ __forceinline__ int p_stride(int spad) {
  return 2 * spad + 16;
}

template <int DQK, int DV>
size_t fwd_smem(int S) {
  return static_cast<size_t>(padded(S)) * (2 * DQK + DV) * sizeof(Bf16);
}

template <int DQK, int DV>
size_t bwd_smem(int S) {
  const int spad = padded(S);
  return static_cast<size_t>(spad) * (2 * DQK + 2 * DV) * sizeof(Bf16) +
         4 * static_cast<size_t>(spad) * p_stride(spad);
}

// bit j: key j of sequence b is a real token (key_ok > 0); by every lane
__device__ __forceinline__ uint64_t real_keys(const float* key_ok, int b,
                                              int S, int lane) {
  const float* row = key_ok + static_cast<size_t>(b) * S;
  const uint32_t lo = __ballot_sync(kFull, lane < S && row[lane] > 0.f);
  const uint32_t hi =
      __ballot_sync(kFull, lane + 32 < S && row[lane + 32] > 0.f);
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// rows [0, n) of one head of x (rows `rs` elements apart from element
// `base`) into a staged [n][D] tile at dst, by every thread of the block; a
// row that is not a real token is zero-filled and not read
template <int D>
__device__ __forceinline__ void stage_real(const Bf16* x, size_t base,
                                           size_t rs, int n, uint64_t real,
                                           uint32_t dst) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = (real >> r) & 1;
    ldot::cp_async16(dst + ldot::swz<kChunks>(r, ch),
                     ok ? x + base + r * rs + ch * 8 : x, ok);
  }
}

// rows [r0, r0 + n) of one head of x set to 0, 16 bytes a lane
template <int D>
__device__ __forceinline__ void zero_rows(Bf16* x, size_t base, size_t rs,
                                          int r0, int n, int lane) {
  constexpr int kChunks = D / 8;
  for (int c = lane; c < n * kChunks; c += 32) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    *reinterpret_cast<uint4*>(x + base + (r0 + r) * rs + ch * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// a warp's 16 x 64 output chunk (the mma C layout: n8 tile n, rows r0 + g
// and r0 + g + 8) times mul, into columns col0.. of its rows below S
__device__ __forceinline__ void store_chunk(Bf16* x, size_t base, size_t rs,
                                            int r0, int S, int col0,
                                            const float (&acc)[8][4],
                                            float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r;
    if (i < S) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(x + base + i * rs + col0 + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(__fmul_rn(acc[n][2 * r], mul),
                                  __fmul_rn(acc[n][2 * r + 1], mul));
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi): the A fragments of k16
// step kb from the float32 accumulators of n8 tiles 2 kb and 2 kb + 1
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  float h0[4], h1[4], l0[4], l1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h0[e] = ldot::round_to<Bf16>(c0[e]);
    h1[e] = ldot::round_to<Bf16>(c1[e]);
    l0[e] = c0[e] - h0[e];
    l1[e] = c1[e] - h1[e];
  }
  ldot::repack_a(hi, h0, h1);
  ldot::repack_a(lo, l0, l1);
}

// the A fragment of the transpose of the 16 x 16 block at rows r0, columns
// c0 of a row-major bf16 tile (rows `stride` bytes apart): A[m][k] =
// tile[r0 + k][c0 + m]
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], uint32_t tile,
                                             int stride, int r0, int c0,
                                             int lane) {
  const int m = lane >> 3;
  ldot::ldsm_x4_trans(a, tile + (r0 + (lane & 7) + ((m >> 1) << 3)) * stride +
                             (c0 + ((m & 1) << 3)) * 2);
}

// acc[n] += a b over the 64 columns n0.. of a staged [k][n] tile with
// kChunks 16-byte chunks a row, k16 step ks; a as a hi/lo pair
template <int kChunks>
__device__ __forceinline__ void times_kn(float (&acc)[8][4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         uint32_t tile, int n0, int ks,
                                         int lane) {
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bf[4];
    ldot::load_b_kn<kChunks>(bf, tile, n0 + 16 * np, ks, lane);
    mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
    mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
    mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
}

// acc[2 kb .. 2 kb + 1] = A B^T for key tiles kb < nk: A the warp's 16
// staged rows r0.. of `a`, B the staged rows of `b`, both with kChunks
// chunks a row (s = q k^T, dp = dO v^T)
template <int KB, int kChunks>
__device__ __forceinline__ void times_nk(float (&acc)[2 * KB][4],
                                         uint32_t a, uint32_t b, int r0,
                                         int nk, int lane) {
#pragma unroll
  for (int n = 0; n < 2 * KB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < kChunks / 2; ++ks) {
    uint32_t af[4];
    ldot::load_a<kChunks>(af, a, r0, ks, lane);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb < nk) {
        uint32_t bf[4];
        ldot::load_b_nk<kChunks>(bf, b, 16 * kb, ks, lane);
        mma_bf16(acc[2 * kb], af, bf[0], bf[1]);
        mma_bf16(acc[2 * kb + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// the block's (sequence, head): its real tokens and where its rows lie
struct Head {
  uint64_t real;    // bit j: token j is real
  int nkb;          // tiles of 16 up to the last real token
  size_t qrs, vrs;  // row strides of q, k and of v, o (elements)
  size_t qbase, vbase;
};

template <int DQK, int DV>
__device__ __forceinline__ Head head_of(const float* key_ok, int S, int NH,
                                        int lane) {
  const int b = blockIdx.x / NH, h = blockIdx.x % NH;
  Head hd;
  hd.real = real_keys(key_ok, b, S, lane);
  hd.nkb = (hd.real ? 64 - __clzll(hd.real) + 15 : 0) / 16;
  hd.qrs = static_cast<size_t>(NH) * DQK;
  hd.vrs = static_cast<size_t>(NH) * DV;
  hd.qbase = (static_cast<size_t>(b) * S * NH + h) * DQK;
  hd.vbase = (static_cast<size_t>(b) * S * NH + h) * DV;
  return hd;
}

// may query i read key j
__device__ __forceinline__ bool allowed(uint64_t real, int i, int j,
                                        int causal) {
  return ((real >> i) & (real >> j) & 1) && (!causal || j <= i);
}

// KB: key tiles of 16 the registers hold (2 for S <= 32, 4 for S <= 64)
template <int KB, int DQK, int DV>
__global__ void __launch_bounds__(32 * KB, 16 / KB)
    mla_fwd_kernel(const Bf16* __restrict__ q, const Bf16* __restrict__ k,
                   const Bf16* __restrict__ v,
                   const float* __restrict__ key_ok, Bf16* __restrict__ o,
                   float* __restrict__ lse, int S, int NH, float scale,
                   int causal) {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "widths of whole 64s");
  constexpr int kQC = DQK / 8, kVC = DV / 8;   // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int spad = padded(S);
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sk = sq + spad * DQK * 2;
  const uint32_t sv = sk + spad * DQK * 2;
  const Head hd = head_of<DQK, DV>(key_ok, S, NH, lane);
  const uint64_t real = hd.real;
  const int nkb = hd.nkb;
  const size_t qrs = hd.qrs, vrs = hd.vrs, qbase = hd.qbase,
               vbase = hd.vbase;
  stage_real<DQK>(q, qbase, qrs, 16 * nkb, real, sq);
  stage_real<DQK>(k, qbase, qrs, 16 * nkb, real, sk);
  stage_real<DV>(v, vbase, vrs, 16 * nkb, real, sv);
  ldot::cp_async_commit();
  ldot::cp_async_wait<0>();
  __syncthreads();

  const int r0 = 16 * warp;
  float* lrow = lse + static_cast<size_t>(blockIdx.x) * S;   // [B, NH, S]
  if (warp >= nkb) {   // no real query in the tile
    zero_rows<DV>(o, vbase, vrs, r0, min(16, S - r0), lane);
    if (lane < 16 && r0 + lane < S) lrow[r0 + lane] = INFINITY;
    return;
  }
  const int nk = causal ? warp + 1 : nkb;   // key tiles the warp reads
  float acc[2 * KB][4];
  times_nk<KB, kQC>(acc, sq, sk, r0, nk, lane);
  // s = acc * scale on allowed pairs, -inf elsewhere; each row's max and
  // sum on its quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 2 * KB; ++n) {
    if (n < 2 * nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok =
            allowed(real, r0 + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1),
                    causal);
        acc[n][e] = ok ? __fmul_rn(acc[n][e], scale) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], acc[n][e]);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < 2 * KB; ++n) {
    if (n < 2 * nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (acc[n][e] != -INFINITY) sum[e >> 1] += expf(acc[n][e] - mx[e >> 1]);
    }
  }
  float L[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
    sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    L[r] = sum[r] > 0.f ? mx[r] + logf(sum[r]) : INFINITY;   // padding: +inf
    const int i = r0 + g + 8 * r;
    if (t == 0 && i < S) lrow[i] = L[r];
  }
  // p = exp(s - lse) as the twin forms it (0 where s is -inf or the row is
  // padding), as hi/lo A fragments
  uint32_t ph[KB][4], pl[KB][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    if (kb < nk) {
#pragma unroll
      for (int n = 2 * kb; n < 2 * kb + 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = expf(acc[n][e] - L[e >> 1]);
      }
      split_a(ph[kb], pl[kb], acc[2 * kb], acc[2 * kb + 1]);
    }
  }
  // o = p v, 64 columns at a time
#pragma unroll
  for (int c = 0; c < DV / 64; ++c) {
    float oc[8][4];
    zero(oc);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb < nk) times_kn<kVC>(oc, ph[kb], pl[kb], sv, 64 * c, kb, lane);
    }
    store_chunk(o, vbase, vrs, r0, S, 64 * c, oc, 1.f, lane);
  }
}

template <int KB, int DQK, int DV>
__global__ void __launch_bounds__(32 * KB, 16 / KB)
    mla_bwd_kernel(const Bf16* __restrict__ q, const Bf16* __restrict__ k,
                   const Bf16* __restrict__ v, const Bf16* __restrict__ o,
                   const Bf16* __restrict__ gr,
                   const float* __restrict__ key_ok,
                   const float* __restrict__ lse, Bf16* __restrict__ dq,
                   Bf16* __restrict__ dk, Bf16* __restrict__ dv, int S,
                   int NH, float scale, int causal) {
  static_assert(DQK % 64 == 0 && DV % 64 == 0, "widths of whole 64s");
  constexpr int kQC = DQK / 8, kVC = DV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int spad = padded(S);
  const int ps = p_stride(spad);
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sq = sbase;
  const uint32_t sk = sq + spad * DQK * 2;
  const uint32_t sv = sk + spad * DQK * 2;
  const uint32_t sg = sv + spad * DV * 2;                 // dO
  const uint32_t sph = sg + spad * DV * 2;                // P hi, P lo,
  const uint32_t spl = sph + spad * ps;                   // dS hi, dS lo:
  const uint32_t sdh = spl + spad * ps;                   // [S][S] bf16
  const uint32_t sdl = sdh + spad * ps;
  const Head hd = head_of<DQK, DV>(key_ok, S, NH, lane);
  const uint64_t real = hd.real;
  const int nkb = hd.nkb;
  const size_t qrs = hd.qrs, vrs = hd.vrs, qbase = hd.qbase,
               vbase = hd.vbase;
  stage_real<DQK>(q, qbase, qrs, 16 * nkb, real, sq);
  stage_real<DQK>(k, qbase, qrs, 16 * nkb, real, sk);
  stage_real<DV>(v, vbase, vrs, 16 * nkb, real, sv);
  stage_real<DV>(gr, vbase, vrs, 16 * nkb, real, sg);
  ldot::cp_async_commit();
  ldot::cp_async_wait<0>();
  __syncthreads();

  const int r0 = 16 * warp;
  const bool active = warp < nkb;   // the tile holds a real token
  // phase 1, the warp's 16 queries
  if (!active) {
    zero_rows<DQK>(dq, qbase, qrs, r0, min(16, S - r0), lane);
  } else {
    const int nk = causal ? warp + 1 : nkb;
    // D = rowsum(dO o) of rows r0 + g and r0 + g + 8: 16 lanes a row, two
    // rows a pass, the sum to the row's quad by a shuffle
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int i = r0 + 2 * pass + (lane >> 4);
      float part = 0.f;
      if ((real >> i) & 1) {
        for (int ch = lane & 15; ch < kVC; ch += 16) {
          const uint4 ov = __ldg(reinterpret_cast<const uint4*>(
              o + vbase + i * vrs + ch * 8));
          const uint4 gv = *reinterpret_cast<const uint4*>(
              smem + (sg - sbase) + ldot::swz<kVC>(i, ch));
          const __nv_bfloat162* op =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* gp =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 of = __bfloat1622float2(op[u]);
            const float2 gf = __bfloat1622float2(gp[u]);
            part += gf.x * of.x;
            part += gf.y * of.y;
          }
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      const float x = __shfl_sync(kFull, part, (g & 1) << 4);
      if (pass == (g >> 1)) D[0] = x;
      if (pass == 4 + (g >> 1)) D[1] = x;
    }
    float sacc[2 * KB][4], pacc[2 * KB][4];
    times_nk<KB, kQC>(sacc, sq, sk, r0, nk, lane);   // s = q k^T
    times_nk<KB, kVC>(pacc, sg, sv, r0, nk, lane);   // dp = dO v^T
    const float* lrow = lse + static_cast<size_t>(blockIdx.x) * S;
    float L[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + g + 8 * r;
      L[r] = i < S ? lrow[i] : INFINITY;
    }
    // p = exp(s - lse), ds = p (dp - D); both to shared memory as hi/lo
    // pairs, ds kept as A fragments for dq
    uint32_t dh[KB][4], dl[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      if (kb < nk) {
#pragma unroll
        for (int n = 2 * kb; n < 2 * kb + 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p =
                allowed(real, r0 + g + 8 * r, 8 * n + 2 * t + (e & 1),
                        causal)
                    ? expf(__fmul_rn(sacc[n][e], scale) - L[r])
                    : 0.f;
            sacc[n][e] = p;
            pacc[n][e] = __fmul_rn(p, pacc[n][e] - D[r]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t at = (r0 + g + 8 * r) * ps + (8 * n + 2 * t) * 2;
            const float p0 = sacc[n][2 * r], p1 = sacc[n][2 * r + 1];
            const float d0 = pacc[n][2 * r], d1 = pacc[n][2 * r + 1];
            const float hp0 = ldot::round_to<Bf16>(p0);
            const float hp1 = ldot::round_to<Bf16>(p1);
            const float hd0 = ldot::round_to<Bf16>(d0);
            const float hd1 = ldot::round_to<Bf16>(d1);
            const uint32_t w[4] = {ldot::pack_bf16(hp0, hp1),
                                   ldot::pack_bf16(p0 - hp0, p1 - hp1),
                                   ldot::pack_bf16(hd0, hd1),
                                   ldot::pack_bf16(d0 - hd0, d1 - hd1)};
            const uint32_t dst[4] = {sph, spl, sdh, sdl};
#pragma unroll
            for (int u = 0; u < 4; ++u)
              asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst[u] + at),
                           "r"(w[u])
                           : "memory");
          }
        }
        split_a(dh[kb], dl[kb], pacc[2 * kb], pacc[2 * kb + 1]);
      }
    }
    // dq = ds k * scale, 64 columns at a time
#pragma unroll
    for (int c = 0; c < DQK / 64; ++c) {
      float acc[8][4];
      zero(acc);
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        if (kb < nk) times_kn<kQC>(acc, dh[kb], dl[kb], sk, 64 * c, kb, lane);
      }
      store_chunk(dq, qbase, qrs, r0, S, 64 * c, acc, scale, lane);
    }
  }
  __syncthreads();
  // phase 2, the warp's 16 keys: the query tiles that may read them
  if (!active) {
    zero_rows<DQK>(dk, qbase, qrs, r0, min(16, S - r0), lane);
    zero_rows<DV>(dv, vbase, vrs, r0, min(16, S - r0), lane);
    return;
  }
  const int q0 = causal ? warp : 0;
#pragma unroll
  for (int c = 0; c < DV / 64; ++c) {   // dv = P^T dO
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int qt = 0; qt < KB; ++qt) {
      if (qt >= q0 && qt < nkb) {
        uint32_t hi[4], lo[4];
        load_a_trans(hi, sph, ps, 16 * qt, r0, lane);
        load_a_trans(lo, spl, ps, 16 * qt, r0, lane);
        times_kn<kVC>(acc, hi, lo, sg, 64 * c, qt, lane);
      }
    }
    store_chunk(dv, vbase, vrs, r0, S, 64 * c, acc, 1.f, lane);
  }
#pragma unroll
  for (int c = 0; c < DQK / 64; ++c) {   // dk = dS^T q * scale
    float acc[8][4];
    zero(acc);
#pragma unroll
    for (int qt = 0; qt < KB; ++qt) {
      if (qt >= q0 && qt < nkb) {
        uint32_t hi[4], lo[4];
        load_a_trans(hi, sdh, ps, 16 * qt, r0, lane);
        load_a_trans(lo, sdl, ps, 16 * qt, r0, lane);
        times_kn<kQC>(acc, hi, lo, sq, 64 * c, qt, lane);
      }
    }
    store_chunk(dk, qbase, qrs, r0, S, 64 * c, acc, scale, lane);
  }
}

// Moonlight's widths (qk_nope 128 + qk_rope 64, v 128)
constexpr int kDqk = 192;
constexpr int kDv = 128;

bool shape_ok(int B, int S, int NH, int DQK, int DV, int dtype,
              std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!ldot::aligned16(p)) return false;
  return B > 0 && S > 0 && S <= kMaxSeq && NH > 0 && DQK == kDqk &&
         DV == kDv && dtype == ldot::kBFloat16;
}

template <int KB>
cudaError_t forward(const void* q, const void* k, const void* v,
                    const float* key_ok, void* o, float* lse, int B, int S,
                    int NH, float scale, int causal, cudaStream_t stream) {
  auto kernel = mla_fwd_kernel<KB, kDqk, kDv>;
  static cudaError_t granted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(fwd_smem<kDqk, kDv>(16 * KB)));
  if (granted != cudaSuccess) return granted;
  kernel<<<B * NH, padded(S) / 16 * 32, fwd_smem<kDqk, kDv>(S), stream>>>(
      static_cast<const Bf16*>(q), static_cast<const Bf16*>(k),
      static_cast<const Bf16*>(v), key_ok, static_cast<Bf16*>(o), lse, S, NH,
      scale, causal);
  return cudaGetLastError();
}

template <int KB>
cudaError_t backward(const void* q, const void* k, const void* v,
                     const void* o, const void* g, const float* key_ok,
                     const float* lse, void* dq, void* dk, void* dv, int B,
                     int S, int NH, float scale, int causal,
                     cudaStream_t stream) {
  auto kernel = mla_bwd_kernel<KB, kDqk, kDv>;
  static cudaError_t granted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem<kDqk, kDv>(16 * KB)));
  if (granted != cudaSuccess) return granted;
  kernel<<<B * NH, padded(S) / 16 * 32, bwd_smem<kDqk, kDv>(S), stream>>>(
      static_cast<const Bf16*>(q), static_cast<const Bf16*>(k),
      static_cast<const Bf16*>(v), static_cast<const Bf16*>(o),
      static_cast<const Bf16*>(g), key_ok, lse, static_cast<Bf16*>(dq),
      static_cast<Bf16*>(dk), static_cast<Bf16*>(dv), S, NH, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k: [B, S, NH, DQK]; v, o: [B, S, NH, DV], contiguous bfloat16 (dtype
// code), 16-byte aligned; key_ok: float32 [B, S] (> 0: a real key); lse:
// float32 [B, NH, S]. S <= 64, (DQK, DV) = (192, 128); anything else
// returns cudaErrorInvalidValue.
extern "C" int ldot_mla_attention(const void* q, const void* k,
                                  const void* v, const float* key_ok,
                                  void* o, float* lse, int B, int S, int NH,
                                  int DQK, int DV, float scale, int causal,
                                  int dtype, void* stream) {
  if (!shape_ok(B, S, NH, DQK, DV, dtype, {q, k, v, o}))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return forward<2>(q, k, v, key_ok, o, lse, B, S, NH, scale, causal, s);
  return forward<4>(q, k, v, key_ok, o, lse, B, S, NH, scale, causal, s);
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
  if (!shape_ok(B, S, NH, DQK, DV, dtype, {q, k, v, o, g, dq, dk, dv}))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 32)
    return backward<2>(q, k, v, o, g, key_ok, lse, dq, dk, dv, B, S, NH,
                       scale, causal, s);
  return backward<4>(q, k, v, o, g, key_ok, lse, dq, dk, dv, B, S, NH, scale,
                     causal, s);
}
