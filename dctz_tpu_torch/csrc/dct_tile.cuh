// The register-tiled fp32 block transform of kernels A, D, E, F and G.
//
// A CTA of 256 threads takes a tile of 64 DCT blocks. The transform of the
// tile is a 64 x 64 x 64 product: the forward kernels (A, E, F, G) compute
// coef[b][k] = sum_m xs[b][m] * B[k][m], D computes x[b][m] = sum_k
// coef[b][k] * B[k][m]. Thread (hi, lo) = (tid >> 4, tid & 15) owns a 4 x 4
// micro-tile: blocks 4*hi .. 4*hi+3 and columns 4*lo .. 4*lo+3 (forward:
// coefficients k, D: positions m), so 16 independent chains. Each step r of
// the reduction reads two float4 from shared memory, four blocks at r and
// four columns at r, for 16 fmaf.
//
// The arithmetic is that of common.cuh:forward_dct / inverse_dct: every
// output is one fmaf chain from 0.f over r = 0..63 in index order. Only the
// mapping of chains to threads differs, so the results are bit-equal to the
// per-thread helpers that the card-only references L_ref and M_ref keep
// (fused_encode_dpk_ref.cu, fused_decode_dpk_ref.cu): L_ref = F -> pack_ids
// -> H and M_ref = C + D are the checks of this header against an independent transform.
//
// The forward kernels share their front end: persistent CTAs that load the
// next tile's samples with cp.async (load_tile_async) while they transform
// this one, the basis transposed into a row tile (load_basis_transposed),
// and xs = x / sf staged into the transposed tile (stage_scaled). Each keeps
// its own epilogue; A, F and G bin through ac_bin.
//
// Layouts (all rows 64 floats, float4 groups permuted by an XOR so that the
// accesses below fall on distinct banks):
//   transposed tile T[r][b]: row r holds the 64 blocks at position r; the
//     float4 of blocks 4q..4q+3 sits at column tcol(r, 4q). Written by
//     stage_transposed (thread (hi, lo) writes rows 4*lo .. 4*lo+3 of blocks
//     4*hi .. 4*hi+3), read by tile_product.
//   row tile R[r][c]: row r, column c at rcol(r, c). A's coefficient tile
//     (row = block; read whole rows by one thread, or one row by a warp) and
//     the forward kernels' transposed basis (row = position m; read by a
//     lane per m).
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

// Start loading tile t's samples into sRaw (block-major, as in x); zeros
// past n_pad. x must lie on 16 bytes (the wrappers pass it through
// dpk_fuse._aligned16).
__device__ __forceinline__ void load_tile_async(float* __restrict__ sRaw,
                                                const float* __restrict__ x,
                                                long long t, long long n_pad,
                                                int tid) {
#pragma unroll
  for (int i = 0; i < TN / 4 / THREADS; ++i) {
    const int c = 4 * (tid + i * THREADS);
    const long long gi = t * TN + c;
    if (gi < n_pad)
      cp_async16(sRaw + c, x + gi);
    else
      st4(sRaw + c, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  cp_async_commit();
}

// The basis B[k][m] (row-major in device memory) into a row tile of its
// transpose: row m holds B[k][m] at rcol(m, k).
__device__ __forceinline__ void load_basis_transposed(
    float* __restrict__ sBT, const float* __restrict__ basis, int tid) {
  for (int i = tid; i < BS * BS; i += THREADS) {
    const int k = i >> 6, m = i & 63;
    sBT[m * BS + rcol(m, k)] = basis[i];
  }
}

// xs = x / sf (a division, as the reference) of the thread's 4 x 4 samples
// of the raw tile (blocks 4*hi + bi, positions 4*lo .. 4*lo+3), in place one
// float4 of a block at a time (few values live across the divisions), then
// into the transposed tile. BLOCK_MAX: also each block's max |xs| into
// mx[b] (the 16 lo-threads of a half-warp per block; the whole warp calls).
template <bool BLOCK_MAX>
__device__ __forceinline__ void stage_scaled(float* __restrict__ sRaw,
                                             float* __restrict__ sT, float sf,
                                             int hi, int lo,
                                             float* __restrict__ mx) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    float* p = sRaw + (4 * hi + bi) * BS + 4 * lo;
    const float4 r = ld4(p);
    const float4 s = make_float4(r.x / sf, r.y / sf, r.z / sf, r.w / sf);
    st4(p, s);
    if constexpr (BLOCK_MAX) {
      float m = fmaxf(fmaxf(fabsf(s.x), fabsf(s.y)), fmaxf(fabsf(s.z), fabsf(s.w)));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lo == 0) mx[4 * hi + bi] = m;
    }
  }
  float v[4][4];
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    const float4 s = ld4(sRaw + (4 * hi + bi) * BS + 4 * lo);
    v[bi][0] = s.x;
    v[bi][1] = s.y;
    v[bi][2] = s.z;
    v[bi][3] = s.w;
  }
  stage_transposed(sT, hi, lo, v);
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

// The bin geometry of the forward kernels' epilogues.
struct Geom {
  float rmin, rmax, w, sf;
  float tol;             // A's verify only
  float eb, qtf, denom;  // QT only
};

// Bin id of AC coefficient c (DC is handled by the caller). EC: its bin if in
// range, else ESCAPE. QT: an out-of-range c is renormalized through q and
// binned if that lands in range (dpk_fuse.py:536-542).
template <bool QT>
__device__ __forceinline__ int ac_bin(float c, float q, const Geom& g) {
  float v = c;
  bool in = c >= g.rmin && c <= g.rmax;
  if constexpr (QT) {
    if (!in) {
      v = qt_renorm(c, q, g.eb, g.qtf, g.rmin, g.rmax);
      in = v >= g.rmin && v <= g.rmax;
    }
  }
  if (!in) return ESCAPE;
  int lin = __float2int_rz((v - g.rmin) / g.w);
  lin = min(max(lin, 0), NBINS - 1);
  return zigzag_of_lin(lin);
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
