// The training attention's keep mask: counter-based Philox4x32-10 keyed on
// the 64-bit seed, one draw per (batch item, head, row, column). Element
// (b, h, i, j) takes word j % 4 of philox(counter (j / 4, i, h, b), key
// (seed lo, seed hi)) and is kept iff it is below (1 - rate) * 2^32. The
// mask is a pure function of its coordinates, so every kernel that needs it
// (the tensor-core forward in attention_mma.cu, the tensor-core backward in
// attention_mma_bwd.cu, the FMA kernels in attention_fused.cu), each blocked
// its own way, regenerates the same mask in registers. The twin is
// ops/attention_fused.py::philox_keep.
#pragma once

#include <cstdint>

namespace ldot {

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32_R(10, ...))
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kW0;
      k.y += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// the key of a seed held in device memory (a layer never waits on the host)
__device__ __forceinline__ uint2 seed_key(const long long* seed) {
  const unsigned long long s = static_cast<unsigned long long>(*seed);
  return make_uint2(static_cast<unsigned>(s), static_cast<unsigned>(s >> 32));
}

__device__ __forceinline__ bool keep_draw(uint2 key, int b, int h, int i,
                                          int j, unsigned thresh) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<unsigned>(j) >> 2, i, h, b), key);
  const int w = j & 3;
  const unsigned bits = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
  return bits < thresh;
}

// The words of one lane's four elements of a 16 x 8 mma accumulator tile
// (lane = 4 g + t; element e at tile row g + 8 (e / 2), column 2 t + e % 2),
// one Philox call per lane, the rest by shuffles.
//
// keep_words_qk: tile rows are draw rows (queries) and columns draw
// columns (keys), as in Q K^T. i = the lane's row g of the tile, j8 = the
// tile's first column (a multiple of 8). A call covers the quad's 2 rows x
// 2 groups of 4 columns (counter (column / 4, row)): lane t draws group t /
// 2 of row i + 8 (t % 2), and lanes t, t ^ 1 swap the words of the row the
// other drew.
__device__ __forceinline__ void keep_words_qk(unsigned (&w)[4], uint2 key,
                                              int i, int j8, int t, int h,
                                              int b) {
  const uint4 r = philox4x32_10(
      make_uint4((j8 >> 2) + (t >> 1), i + 8 * (t & 1), h, b), key);
  const bool odd = t & 1;
  const unsigned s0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const unsigned s1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  w[0] = odd ? s0 : r.x;
  w[1] = odd ? s1 : r.y;
  w[2] = odd ? r.z : s0;
  w[3] = odd ? r.w : s1;
}

__device__ __forceinline__ unsigned pick4(const unsigned (&x)[4], int k) {
  return k == 0 ? x[0] : k == 1 ? x[1] : k == 2 ? x[2] : x[3];
}

// keep_words_kq: the transposed tile of the dk/dv kernel, rows are draw
// columns (keys) and columns draw rows (queries), as in K Q^T. j16 = the
// tile's first row (a multiple of 16), i = its first column + 2 t (the
// lane's first query). The lane's keys j16 + g and j16 + g + 8 take words
// g % 4 of counters j16 / 4 + g / 4 and that + 2; its queries i, i + 1. The
// four lanes of one (g / 4, t), which differ in g % 4 = r, need the same
// four counters: lane r draws element r's counter (key row r / 2, query r
// % 2), and a 4 x 4 transpose over shuffles (lane masks 4, 8, 12) hands
// each lane word r of every draw.
__device__ __forceinline__ void keep_words_kq(unsigned (&w)[4], uint2 key,
                                              int j16, int i, int g, int h,
                                              int b) {
  const int r = g & 3;
  const uint4 d = philox4x32_10(
      make_uint4((j16 >> 2) + (g >> 2) + 2 * (r >> 1), i + (r & 1), h, b),
      key);
  const unsigned mine[4] = {d.x, d.y, d.z, d.w};
  // got[k]: word r of the draw of lane r ^ k, i.e. element r ^ k
  unsigned got[4];
  got[0] = pick4(mine, r);
#pragma unroll
  for (int k = 1; k < 4; ++k)
    got[k] = __shfl_xor_sync(0xffffffffu, pick4(mine, r ^ k), k << 2);
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = pick4(got, e ^ r);
}

}  // namespace ldot
