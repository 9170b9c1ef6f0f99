// bfloat16 self-attention forward on the tensor cores, for sequences up to
// 256 and head_dim up to 64: out = softmax(q k^T * scale + key_bias) v,
// with an optional dropout of the probabilities.
//
// Replaces, in bfloat16, the TPU kernels lightningdot_tpu/ops/attention.py::
// _attn_kernel (:87; here through ldot_attention, attention.cu) and
// lightningdot_tpu/ops/experimental/attention_fused.py::_fwd_kernel (:117;
// through ldot_attention_train_fwd, attention_fused.cu). The float32 forms
// stay on those files' FMA kernels, bit-equal to their twins: the tensor
// cores have no float32 product, and TF32 would not be float32.
//
// Rounding points, as the twins (ops/attention.py::_attention_math,
// ops/attention_fused.py::_fused_attn_fwd_math): s = (q . k) * scale + bias
// in float32 (bf16 products, float32 sums: JAX's DEFAULT precision); the
// row's global max (no running max: e is rounded relative to it); e = exp(s
// - max) and its float32 row sum, un-rounded; then
//   deferred:   e rounded to bf16 before e . v, the division by the sum
//               after it (B2, bf16 serving);
//   normalized: p = e / sum (IEEE), rounded to bf16 (B2 with defer=0, B5 at
//               rate 0), then with dropout round_bf16(p * mscale) where the
//               Philox word keeps it, else 0 (B5 at rate > 0).
// Only the order of the float32 sums differs from the twins (the tensor
// cores' dot products; a row's sum per lane, then across its quad).
//
// Bound: per head the work is 4 S^2 D flops on 4 S D bf16 elements, S / 2
// <= 128 flops per byte, below the card's ridge (~295): the bytes bound it
// at every path shape (15.0 us at [128, 64, 12, 64], 24.4 us at [128, 104],
// 7.5 us for the training forward at [64, 64]).
//
// Design: one block per (batch item, head, tile of up to 64 query rows),
// one warp per 16 rows (fewer warps when S < 64: the batch-1 query at S 32
// runs 12 blocks of 2 warps). The head's K and V (S padded to a multiple of
// 16 with zero rows) and the Q tile are staged in shared memory as bf16
// (D padded to 64 with zeros), half the bytes of a float32 staging, through
// 16-byte cp.async copies in two commit groups, (Q, K) then V, so V lands
// while Q K^T runs; each 128-byte row's 16-byte chunks are permuted by row
// % 8, so every ldmatrix is free of bank conflicts: 24 KB of shared memory
// at S 64, 41 KB at S 128, 73 KB at S 256. ptxas (-Xptxas -v, sm_90a) reads
// 64 / 74 / 125 / 189 registers for the deferred kernels of the 32-, 64-,
// 128- and 256-key buckets (66 / 79 / 114 / 182 normalized), no spills: 16
// blocks of 2 warps per SM at S 32, then 6 / 4 / 2 blocks of 4 warps, the
// registers the limit (shared memory would allow 9 / 5 / 3). The products
// are mma.sync m16n8k16 (bf16 in, float32 accumulate; the staging,
// ldmatrix and mma helpers are mma.cuh's, shared with the backward and the
// FFN): Q K^T with Q by ldmatrix.x4 and K read non-transposed from its
// [S][D] rows; P V with the score accumulators
// repacked in registers as the A fragments (two n8 tiles per k16 step) and
// V by ldmatrix.trans. The softmax runs in registers: a row's values sit on
// a quad of 4 lanes, reduced by __shfl_xor 1 and 2; no score reaches shared
// memory. The score tile is a register array sized by a template bucket of
// the key count (32, 64, 128 or 256 keys). Padded keys score -inf (their e
// is exactly 0) and padded V rows are zero (0 x garbage could be NaN). No
// atomics: the same inputs give the same bits on every launch. Not wgmma:
// a head's product is 16 x S x 64 per warp, below the ridge, and 64-row
// warpgroup tiles with shared-memory descriptors buy nothing that the bytes
// would let them use.
#include <cstdint>

#include "attention_mma.cuh"
#include "mma.cuh"
#include "philox.cuh"

namespace {

constexpr int kMaxSeq = 256;
constexpr int kMaxHeadDim = 64;
constexpr int kRowBytes = kMaxHeadDim * 2;   // a staged row, D padded to 64
constexpr int kMaxRows = 64;                 // query rows per block
constexpr unsigned kFull = 0xffffffffu;

enum Epilogue : int { kDeferred = 0, kNormalized = 1 };

// query rows per block: 16 per warp, up to 4 warps
int tile_rows(int seq) {
  return seq >= kMaxRows ? kMaxRows : (seq + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int padded(int seq) {
  return (seq + 15) / 16 * 16;
}

size_t smem_bytes(int rows, int spad) {
  return static_cast<size_t>(rows + 2 * spad) * kRowBytes +
         static_cast<size_t>(spad) * sizeof(float);
}

using ldot::cp_async_commit;
using ldot::cp_async_wait;
using ldot::mma_bf16;

// KB: key blocks of 16 the score registers hold (the bucket of padded(S)
// / 16); EPI: the epilogue
template <int KB, int EPI>
__global__ void __launch_bounds__(kMaxRows / 16 * 32)
    attention_mma_kernel(ldot::AttnMma a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.seq, D = a.head_dim;
  const int spad = padded(S);
  const int nkb = spad / 16;               // key blocks of 16, <= KB
  const int nks = (D + 15) / 16;           // k16 steps over the head dim
  const int rows = blockDim.x / 32 * 16;   // query rows of the tile
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sk = sq + rows * kRowBytes;
  const uint32_t sv = sk + spad * kRowBytes;
  float* sbias =
      reinterpret_cast<float*>(smem + (rows + 2 * spad) * kRowBytes);

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x % a.heads;
  const int i0 = blockIdx.y * rows;        // first query row of the tile
  const size_t rs = static_cast<size_t>(a.heads) * D;
  const size_t base = static_cast<size_t>(b) * S * rs +
                      static_cast<size_t>(h) * D;
  const int chunks = D / 8;

  // (Q, K), then V: V arrives while Q K^T runs
  ldot::stage<8>(a.q, base, rs, i0, rows, S - i0, chunks, sq);
  ldot::stage<8>(a.k, base, rs, 0, spad, S, chunks, sk);
  cp_async_commit();
  ldot::stage<8>(a.v, base, rs, 0, spad, S, chunks, sv);
  cp_async_commit();
  for (int j = threadIdx.x; j < spad; j += blockDim.x)
    sbias[j] = j < S ? a.bias[static_cast<size_t>(b) * S + j] : -INFINITY;
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                 // the lane's rows: g and g + 8
  const int t = lane & 3;                  // its columns: 2t, 2t + 1 of 8
  const int wr = warp * 16;                // the warp's rows in the tile
  const bool active = i0 + wr < S;
  // acc[n][e]: row g + 8 (e / 2), key 8 n + 2 t + e % 2 (the mma C layout)
  float acc[2 * KB][4];
  float sum[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int n = 0; n < 2 * KB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    // S = Q K^T
#pragma unroll
    for (int ks = 0; ks < kMaxHeadDim / 16; ++ks) {
      if (ks < nks) {
        uint32_t qa[4];
        ldot::load_a<8>(qa, sq, wr, ks, lane);
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          if (kb < nkb) {
            uint32_t kf[4];
            ldot::load_b_nk<8>(kf, sk, 16 * kb, ks, lane);
            mma_bf16(acc[2 * kb], qa, kf[0], kf[1]);
            mma_bf16(acc[2 * kb + 1], qa, kf[2], kf[3]);
          }
        }
      }
    }
    // s = acc * scale + bias, and the row max over all keys
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * KB; ++n) {
      if (n < 2 * nkb) {
        const float b0 = sbias[8 * n + 2 * t];
        const float b1 = sbias[8 * n + 2 * t + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], a.scale),
                                (e & 1) ? b1 : b0);
          mx[e >> 1] = fmaxf(mx[e >> 1], acc[n][e]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    // e = exp(s - max), and its float32 sum, un-rounded
#pragma unroll
    for (int n = 0; n < 2 * KB; ++n) {
      if (n < 2 * nkb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(acc[n][e] - mx[e >> 1]);
          acc[n][e] = x;
          sum[e >> 1] += x;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
    }
    if (EPI == kDeferred) {
#pragma unroll
      for (int n = 0; n < 2 * KB; ++n) {
        if (n < 2 * nkb) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = ldot::round_to<__nv_bfloat16>(acc[n][e]);
        }
      }
    } else {
      const uint2 key = a.dropout ? ldot::seed_key(a.seed) : make_uint2(0, 0);
      const int row = i0 + wr + g;
#pragma unroll
      for (int n = 0; n < 2 * KB; ++n) {
        if (n < 2 * nkb) {
          // the Philox words of the lane's 4 elements (philox.cuh)
          unsigned w[4] = {0u, 0u, 0u, 0u};
          if (a.dropout) ldot::keep_words_qk(w, key, row, 8 * n, t, h, b);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ldot::round_to<__nv_bfloat16>(
                __fdiv_rn(acc[n][e], sum[e >> 1]));
            if (a.dropout)
              p = w[e] < a.thresh
                      ? ldot::round_to<__nv_bfloat16>(__fmul_rn(p, a.mscale))
                      : 0.f;
            acc[n][e] = p;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // O = P V, P from the score registers: key block kb is n8 tiles 2 kb and
  // 2 kb + 1, i.e. the A fragment's column halves
  float o[kMaxHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxHeadDim / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    if (kb < nkb) {
      uint32_t pa[4];
      ldot::repack_a(pa, acc[2 * kb], acc[2 * kb + 1]);
#pragma unroll
      for (int dp = 0; dp < kMaxHeadDim / 16; ++dp) {
        if (dp < nks) {
          uint32_t vf[4];
          ldot::load_b_kn<8>(vf, sv, 16 * dp, kb, lane);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kMaxHeadDim / 8; ++n) {
    const int d = 8 * n + 2 * t;
    if (d < D) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + wr + g + 8 * r;
        if (i < S) {
          float x0 = o[n][2 * r], x1 = o[n][2 * r + 1];
          if (EPI == kDeferred) {
            x0 = __fdiv_rn(x0, sum[r]);
            x1 = __fdiv_rn(x1, sum[r]);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              a.out + base + static_cast<size_t>(i) * rs + d) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

template <int KB, int EPI>
cudaError_t launch(const ldot::AttnMma& a, int batch, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be granted explicitly; grant
  // the bucket's largest shape once per instantiation
  static cudaError_t granted = cudaFuncSetAttribute(
      attention_mma_kernel<KB, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxRows, 16 * KB)));
  if (granted != cudaSuccess) return granted;
  const int rows = tile_rows(a.seq);
  const dim3 grid(batch * a.heads, (a.seq + rows - 1) / rows);
  attention_mma_kernel<KB, EPI>
      <<<grid, rows / 16 * 32, smem_bytes(rows, padded(a.seq)), stream>>>(a);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_bucket(const ldot::AttnMma& a, int batch,
                          cudaStream_t stream) {
  const int nkb = padded(a.seq) / 16;
  if (nkb <= 2) return launch<2, EPI>(a, batch, stream);
  if (nkb <= 4) return launch<4, EPI>(a, batch, stream);
  if (nkb <= 8) return launch<8, EPI>(a, batch, stream);
  return launch<16, EPI>(a, batch, stream);
}

}  // namespace

namespace ldot {

cudaError_t attention_mma(const AttnMma& a, int batch, int normalize,
                          cudaStream_t stream) {
  if (batch <= 0 || a.seq <= 0 || a.heads <= 0 || a.head_dim <= 0 ||
      a.seq > kMaxSeq || a.head_dim > kMaxHeadDim || a.head_dim % 8 != 0 ||
      !ldot::aligned16(a.q) || !ldot::aligned16(a.k) ||
      !ldot::aligned16(a.v) || !ldot::aligned16(a.out) ||
      (a.dropout && !normalize))
    return cudaErrorInvalidValue;
  if (normalize) return launch_bucket<kNormalized>(a, batch, stream);
  return launch_bucket<kDeferred>(a, batch, stream);
}

}  // namespace ldot
