// The register-tiled fp32 block transform of kernels A and D.
//
// A CTA of 256 threads takes a tile of 64 DCT blocks. The transform of the
// tile is a 64 x 64 x 64 product: A computes coef[b][k] = sum_m xs[b][m] *
// B[k][m], D computes x[b][m] = sum_k coef[b][k] * B[k][m]. Thread (hi, lo)
// = (tid >> 4, tid & 15) owns a 4 x 4 micro-tile: blocks 4*hi .. 4*hi+3 and
// columns 4*lo .. 4*lo+3 (A: coefficients k, D: positions m), so 16
// independent chains. Each step r of the reduction reads two float4 from
// shared memory, four blocks at r and four columns at r, for 16 fmaf.
//
// The arithmetic is that of common.cuh:forward_dct / inverse_dct: every
// output is one fmaf chain from 0.f over r = 0..63 in index order. Only the
// mapping of chains to threads changed, so the results are bit-equal to the
// per-thread helpers that kernels E, F, G, L and M still use.
//
// Layouts (all rows 64 floats, float4 groups permuted by an XOR so that the
// accesses below fall on distinct banks):
//   transposed tile T[r][b]: row r holds the 64 blocks at position r; the
//     float4 of blocks 4q..4q+3 sits at column tcol(r, 4q). Written by
//     stage_transposed (thread (hi, lo) writes rows 4*lo .. 4*lo+3 of blocks
//     4*hi .. 4*hi+3), read by tile_product.
//   row tile R[r][c]: row r, column c at rcol(r, c). A's coefficient tile
//     (row = block; read whole rows by one thread, or one row by a warp) and
//     A's transposed basis (row = position m; read by a lane per m).
//   D's basis is B[k][m] as it comes, row k read whole by the 16 lo-threads.

#pragma once

#include "common.cuh"

namespace dctz {
namespace tile {

constexpr int TB = 64;           // DCT blocks per CTA tile
constexpr int TN = TB * BS;      // samples per CTA tile
constexpr int THREADS = 256;     // 16 x 16 micro-tiles of 4 x 4
constexpr int WARPS = THREADS / 32;

// Column of block b in row r of a transposed tile.
__device__ __forceinline__ int tcol(int r, int b) {
  return b ^ (((r >> 2) & 7) << 2);
}

// Column of c in row r of a row tile.
__device__ __forceinline__ int rcol(int r, int c) { return c ^ ((r & 15) << 2); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 16 bytes from device memory into shared memory, asynchronously (cp.async:
// the next tile's loads overlap this tile's transform).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v[bi][j]: block 4*hi + bi at row 4*lo + j, into the transposed tile.
__device__ __forceinline__ void stage_transposed(float* __restrict__ sT,
                                                 int hi, int lo,
                                                 const float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = 4 * lo + j;
    st4(sT + r * BS + tcol(r, 4 * hi),
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]));
  }
}

// acc[bi][ci] = fmaf chain over r = 0..63 of T[r][4*hi + bi] * R[r][4*lo + ci],
// from 0.f. SWIZZLED_R: R is a row tile (rcol); else plain rows.
template <bool SWIZZLED_R>
__device__ __forceinline__ void tile_product(const float* __restrict__ sT,
                                             const float* __restrict__ sR,
                                             int hi, int lo,
                                             float (&acc)[4][4]) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) acc[bi][ci] = 0.f;
#pragma unroll 16
  for (int r = 0; r < BS; ++r) {
    const float4 t = ld4(sT + r * BS + tcol(r, 4 * hi));
    const float4 v = ld4(sR + r * BS + (SWIZZLED_R ? rcol(r, 4 * lo) : 4 * lo));
    const float tv[4] = {t.x, t.y, t.z, t.w};
    const float rv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int bi = 0; bi < 4; ++bi)
#pragma unroll
      for (int ci = 0; ci < 4; ++ci)
        acc[bi][ci] = fmaf(tv[bi], rv[ci], acc[bi][ci]);
  }
}

constexpr int MAX_DEVICES = 64;

// Resident CTAs per SM of a tile kernel, with the shared-memory carveout at
// its maximum (the launches ask for it, so that several CTAs fit).
template <class Kernel>
int tile_ctas_per_sm(Kernel kernel, size_t smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return ctas_per_sm(kernel, THREADS, smem);
}

// CTAs of a persistent grid over `tiles` tiles: resident CTAs per SM times
// SMs, at most `tiles`; cached per device in `cache`; 0 on an error.
template <class Kernel>
long long persistent_grid(Kernel kernel, size_t smem, long long tiles,
                          int (&cache)[MAX_DEVICES]) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return 0;
  if (cache[dev] <= 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cache[dev] = tile_ctas_per_sm(kernel, smem) * sms;
  }
  return cache[dev] < tiles ? cache[dev] : tiles;
}

}  // namespace tile
}  // namespace dctz
