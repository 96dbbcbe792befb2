// Shared geometry and helpers of the DPK EC kernels (see ops/dpk_fuse.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dctz {

constexpr int BS = 64;                 // DCT block size
constexpr int TILE_B = 256;            // DCT blocks per DPK tile
constexpr int TILE_N = TILE_B * BS;    // samples per tile
constexpr int NBINS = 255;
constexpr int HALF = NBINS / 2;
constexpr int ESCAPE = 255;            // bin id of a stored (escaped) value
constexpr unsigned FULL = 0xffffffffu;

// Closed-form conv_tbl: linear bin -> zigzag-from-center id.
__device__ __forceinline__ int zigzag_of_lin(int lin) {
  return lin <= HALF ? 2 * (HALF - lin) : 2 * (lin - HALF) - 1;
}

// Closed-form bin center of a zigzag id, in float32 like the JAX package:
// (id odd ? id/2 + 1 : -(id/2)) converted to float, times w.
__device__ __forceinline__ float center_of(int id, float w) {
  const int k2 = id >> 1;
  return static_cast<float>((id & 1) ? k2 + 1 : -k2) * w;
}

// Lanes below this one, for ballot prefix counts.
__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

}  // namespace dctz
