// The chunk-row walk of kernels B (dpk_pack_compact.cu) and C
// (dpk_unpack_expand.cu).
//
// A warp step covers 512 samples of a tile, blocks 8s .. 8s+7 of step s, in
// four sub-steps k of 128 samples: at sub-step k, lane l takes positions
// 4m .. 4m+3 (m = l & 15) of block 8s + 2k + (l >> 4). So a lane holds 16
// samples as four 32-bit words, and each sub-step's ids (32-bit stores) and
// AC values (16-byte stores) fill whole 128- and 512-byte spans per warp.
//
// Ranks of a stable compaction in the sample order: a lane packs its four
// sub-steps' counts (0..4 each) into the four bytes of one word, and one
// inclusive shuffle scan over the lanes of its chunk row gives every
// sub-step's prefix at once (a byte's sum over 32 lanes stays below 256).
// Chunk rows are cw samples: 4 sub-steps at cw = 512, 2 at 256, 1 at 128,
// half a sub-step at 64 (one row per half-warp, scanned over 16 lanes), and
// cw/512 steps at cw >= 1024, which one warp walks in order.
#pragma once

#include "dct_tile.cuh"

namespace dctz {
namespace walk {

constexpr int STEP = 512;            // samples per warp step
constexpr int SUB = 128;             // samples per sub-step
constexpr int WARPS = TILE_B / 32;   // warps per CTA (256 threads)

// Byte j of w.
__device__ __forceinline__ int byte_of(unsigned w, int j) {
  return static_cast<int>((w >> (8 * j)) & 0xffu);
}

struct Walk {
  int lcw;     // log2(cw): cw is a power of two, 64 .. 16384
  int width;   // lanes of a chunk row within a sub-step: 16 at cw = 64, else 32
  int steps;   // steps per unit (cw/512 at cw >= 1024, else 1)
  int units;   // units of a tile (a unit: max(cw, 512) samples)
  int half;    // lane >> 4
  int m;       // lane & 15: positions 4m .. 4m+3
  int gl;      // this lane's index among its row's lanes

  __device__ __forceinline__ explicit Walk(int cw) {
    const int lane = threadIdx.x & 31;
    lcw = __ffs(cw) - 1;
    width = lcw == 6 ? 16 : 32;
    steps = lcw > 9 ? 1 << (lcw - 9) : 1;
    units = TILE_N / STEP / steps;
    half = lane >> 4;
    m = lane & 15;
    gl = lane & (width - 1);
  }
  // tile block of this lane at step s, sub-step k
  __device__ __forceinline__ int block(int s, int k) const {
    return 8 * s + 2 * k + half;
  }
  // chunk row (within the tile) of this lane at step s, sub-step k
  __device__ __forceinline__ int row(int s, int k) const {
    return ((STEP * s + SUB * k) >> lcw) + (lcw == 6 ? half : 0);
  }
  // does a chunk row start at / end after sub-step k of step s
  __device__ __forceinline__ bool starts(int s, int k) const {
    return ((STEP * s + SUB * k) & ((1 << lcw) - 1)) == 0;
  }
  __device__ __forceinline__ bool ends(int s, int k) const {
    return ((STEP * s + SUB * (k + 1)) & ((1 << lcw) - 1)) == 0;
  }
  // inclusive sum of v over the row's lanes up to this one, bytewise
  __device__ __forceinline__ unsigned scan(unsigned v) const {
    const int gl_ = gl;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d >= width) break;
      const unsigned t = __shfl_up_sync(FULL, v, d, width);
      if (gl_ >= d) v += t;
    }
    return v;
  }
  // the row's sum of v (bytewise), in every lane of the row: one warp
  // reduction, off the scan's dependency chain, or a butterfly over a
  // half-warp at cw = 64
  __device__ __forceinline__ unsigned total(unsigned v) const {
    if (width == 32) return __reduce_add_sync(FULL, v);
#pragma unroll
    for (int d = 8; d >= 1; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    return v;
  }
  // bases[k]: the rank in its chunk row of the first of sub-step k's
  // samples, from the sub-steps' totals (bytes of tot) and the count the
  // row carried into this step; returns the count to carry out
  __device__ __forceinline__ int bases(int s, unsigned tot, int carried,
                                       int (&base)[4]) const {
    int run = carried;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (starts(s, k)) run = 0;
      base[k] = run;
      run += byte_of(tot, k);
    }
    return run;
  }
};

// Four counts (0..4) in the bytes of one word.
__device__ __forceinline__ unsigned pack4(int c0, int c1, int c2, int c3) {
  return static_cast<unsigned>(c0 | (c1 << 8) | (c2 << 16) | (c3 << 24));
}

// Byte tests in 32-bit words, exact per byte (no carry crosses a byte):
// bit 7 of a byte of the result is set where the test holds, the other
// bits are 0. (The SIMD intrinsics __vcmp*4 and __vminu4 are emulated on
// sm_90 with several instructions each.)
constexpr unsigned HI = 0x80808080u;

// bytes of x that are 0
__device__ __forceinline__ unsigned zero_bytes_of(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & HI;
}
// bytes of x that are 0xff
__device__ __forceinline__ unsigned ff_bytes_of(unsigned x) {
  return ((x & 0x7f7f7f7fu) + 0x01010101u) & x & HI;
}
// bytes of n (each 0..16) that are >= the byte of t (each 0..16)
__device__ __forceinline__ unsigned ge_bytes_of(unsigned n, unsigned t) {
  return (n + (HI - t)) & HI;
}
// min(x, 15) per byte
__device__ __forceinline__ unsigned clamp15(unsigned x) {
  const unsigned big = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x10101010u;
  return (x & 0x0f0f0f0fu) | (big - (big >> 4));
}
// the base bit of the byte whose bit 7 is the lowest set bit of mk
__device__ __forceinline__ int low_byte_bit(unsigned mk) {
  return __ffs(mk) - 8;
}

}  // namespace walk
}  // namespace dctz
