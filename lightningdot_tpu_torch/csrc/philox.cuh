// The training attention's keep mask: counter-based Philox4x32-10 keyed on
// the 64-bit seed, one draw per (batch item, head, row, column). Element
// (b, h, i, j) takes word j % 4 of philox(counter (j / 4, i, h, b), key
// (seed lo, seed hi)) and is kept iff it is below (1 - rate) * 2^32. The
// mask is a pure function of its coordinates, so every kernel that needs it
// (the tensor-core forward in attention_mma.cu, the backward kernels in
// attention_fused.cu), each blocked its own way, regenerates the same mask
// in registers. The twin is ops/attention_fused.py::philox_keep.
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

}  // namespace ldot
