// Tensor-core building blocks shared by the port's bfloat16 kernels (the
// attention forward, attention_mma.cu; the training attention's backward,
// attention_mma_bwd.cu; the FFN and dh1, ffn_mma.cu) and the int8 FFN
// (ffn_int8.cu): cp.async staging into swizzled shared memory, ldmatrix,
// mma.sync m16n8k16 (bf16 in, float32 accumulate) and m16n8k32 (int8 in,
// int32 accumulate), for sm_90a.
//
// The mma C layout, which every kernel's epilogue and repack follows: lane
// = 4 g + t holds c[0], c[1] at row g, columns 2t, 2t + 1 of the 16 x 8
// tile and c[2], c[3] at row g + 8. The A fragment of a 16 x 16 tile is two
// such accumulator tiles side by side, packed two bf16 to a register
// (pack_bf16): the accumulators of n8 tiles 2 kb and 2 kb + 1 are, lane for
// lane, the A operand of k16 step kb.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ldot {

// byte offset of 16-byte chunk ch of staged row r, in rows of kChunks
// 16-byte chunks (a multiple of 8): within each group of 8 chunks the chunk
// index is permuted by r % 8, so the 8 rows that one ldmatrix matrix reads
// fall in 8 distinct groups of 4 banks
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  static_assert(kChunks % 8 == 0, "rows of whole 128-byte lines");
  return static_cast<uint32_t>(r * kChunks * 16 + ((ch ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; ok = false reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), c 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: a 16 x 32 int8 (row), b 32 x 8 int8 (col), c 16 x 8 int32,
// exact. The fragments lie as those of mma_bf16 when a 16-byte chunk holds
// 16 int8 values instead of 8 bf16 ones, so load_a and load_b_nk load them
// unchanged, with ks counting k32 steps
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16-exact floats as one A-fragment register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of k16 step kb from the accumulators of n8 tiles 2 kb and
// 2 kb + 1 (each value already bf16-exact)
__device__ __forceinline__ void repack_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// A fragment (16 rows x 16 columns) at row r0, k16 step ks of a staged
// [rows][kChunks * 8] tile
template <int kChunks>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, int r0,
                                       int ks, int lane) {
  ldsm_x4(a, tile + swz<kChunks>(r0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// B fragments of two n8 tiles (16 columns n0..n0 + 15) at k16 step ks, B
// staged with n as rows: [n][k] (K of Q K^T). b[0], b[1] feed n8 tile n0,
// b[2], b[3] tile n0 + 8
template <int kChunks>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], uint32_t tile,
                                          int n0, int ks, int lane) {
  const int m = lane >> 3;
  ldsm_x4(b, tile + swz<kChunks>(n0 + (lane & 7) + ((m >> 1) << 3),
                                 2 * ks + (m & 1)));
}

// the same two n8 tiles with B staged as [k][n] (V of P V, row-major
// weights): k rows 16 ks..16 ks + 15, n chunks n0 / 8 and n0 / 8 + 1
template <int kChunks>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], uint32_t tile,
                                          int n0, int ks, int lane) {
  const int m = lane >> 3;
  ldsm_x4_trans(b, tile + swz<kChunks>(16 * ks + (lane & 7) + ((m & 1) << 3),
                                       (n0 >> 3) + (m >> 1)));
}

// rows [r0, r0 + n) of x (rows `rs` elements apart, starting at element
// `base`) into a staged [n][kChunks * 8] tile at dst, by all threads of the
// block; zeros from row `valid` on and from chunk `chunks` on
template <int kChunks>
__device__ __forceinline__ void stage(const __nv_bfloat16* x, size_t base,
                                      size_t rs, int r0, int n, int valid,
                                      int chunks, uint32_t dst) {
  for (int c = threadIdx.x; c < n * kChunks; c += blockDim.x) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = r < valid && ch < chunks;
    const __nv_bfloat16* src =
        ok ? x + base + static_cast<size_t>(r0 + r) * rs + ch * 8 : x;
    cp_async16(dst + swz<kChunks>(r, ch), src, ok);
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace ldot
