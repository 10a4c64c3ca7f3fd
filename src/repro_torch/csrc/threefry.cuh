// Counter-based Threefry-2x32 and the Gumbel noise built on it.
//
// Device twin of src/repro/kernels/prng.py (threefry2x32 / uniform01 /
// gumbel): the standard 20-round Threefry-2x32 block cipher in native
// uint32 arithmetic, so the bits equal JAX's exactly. Every kernel of the
// port that draws per-(point, cluster) noise includes this header.
//
//   bits = threefry2x32(key, counter = (global point index, slot id)).x0
//   u    = ((bits >> 8) + 0.5) * 2^-24        in (0, 1]
//   g    = -log(-log(u))                      standard Gumbel
//
// u is 1.0 (and g is +inf) for bits >= 0xFFFFFF00, as in the reference:
// the top step rounds up in float32 (ROADMAP.md, faults).
//
// Built without --use_fast_math: logf (not __logf) keeps g within a few
// ulp of the host's float32 log.
#pragma once

#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of Threefry-2x32 of counter (c0, c1) under key (k0, k1).
__device__ __forceinline__ uint32_t threefry2x32_x0(uint32_t k0, uint32_t k1,
                                                    uint32_t c0, uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0;
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float gumbel(uint32_t k0, uint32_t k1, uint32_t c0,
                                        uint32_t c1) {
  return -logf(-logf(uniform01(threefry2x32_x0(k0, k1, c0, c1))));
}

}  // namespace repro_torch
