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
//
// The relaxed analysis (CodecConfig.dct_precision = "high"; the instantiations
// of A, E, F and G with RELAXED set) takes the forward product through
// tile_product_bf16x3 instead: xs and the basis are each split into bfloat16
// hi and lo parts (split_bf16, round to nearest even both times, as
// astype(bfloat16) in dctz_tpu/ops/dpk_fuse.py:_dot_bf16x3) and the three
// products d(xs_hi, B_lo), d(xs_lo, B_hi), d(xs_hi, B_hi) run on the tensor
// cores (mma.sync m16n8k16, bf16 in, float32 accumulators), each into its own
// accumulator, summed in the reference's order (d1 + d2) + d3. Products of
// bfloat16 values are exact in float32, so the result differs from the
// reference's only by the order of the float32 accumulation inside each d.
// The bf16 tiles (64 rows of 64 values, 8 KB): row r holds its 16-byte chunks
// permuted by an XOR with (r & 7) (hcol), so that the 8 row reads of each
// ldmatrix fall on distinct banks. xs is split at staging into two [block][m]
// tiles in the raw buffer's own space (stage_scaled<.., true>), the basis
// once per CTA into two [k][m] tiles (load_basis_split): the mma's A operand
// is row-major blocks x m, its B operand column-major m x k, which is B[k][m]
// row-major. The result goes to the coefficient tile (the transposed tile's
// space) in the row layout as each warp finishes a half, so that no thread
// holds more than 8 results; each thread then reads its 4 x 4 micro-tile
// (load_micro_tile), as tile_product leaves it in acc, and the epilogues do
// not change. The raw buffer takes the next tile's samples only after the
// product (it holds the sample tiles until then): those loads overlap the
// epilogue rather than the product.

#pragma once

#include <cuda_bf16.h>

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

// Column of c in row r of a bf16 tile: the 16-byte chunk of 8 values moved
// by an XOR with (r & 7).
__device__ __forceinline__ int hcol(int r, int c) {
  return (((c >> 3) ^ (r & 7)) << 3) | (c & 7);
}

constexpr int HT = BS * BS;  // values of a bf16 tile

// v into bfloat16 hi = v rounded to nearest even and lo = (v - hi) rounded
// to nearest even (v - hi is exact in float32).
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ unsigned pack_bf16x2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// v[bi][j]: block 4*hi + bi at position 4*lo + j, split into the bf16 tiles
// sXh, sXl ([block][m], hcol), 8 bytes per block and tile.
__device__ __forceinline__ void stage_split(__nv_bfloat16* __restrict__ sXh,
                                            __nv_bfloat16* __restrict__ sXl,
                                            int hi, int lo,
                                            const float (&v)[4][4]) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    const int b = 4 * hi + bi;
    __nv_bfloat16 h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_bf16(v[bi][j], h[j], l[j]);
    const int o = b * BS + hcol(b, 4 * lo);
    *reinterpret_cast<uint2*>(sXh + o) =
        make_uint2(pack_bf16x2(h[0], h[1]), pack_bf16x2(h[2], h[3]));
    *reinterpret_cast<uint2*>(sXl + o) =
        make_uint2(pack_bf16x2(l[0], l[1]), pack_bf16x2(l[2], l[3]));
  }
}

// The basis B[k][m] split into the bf16 tiles sBh, sBl: row k holds B[k][m]
// at hcol(k, m). Once per CTA.
__device__ __forceinline__ void load_basis_split(__nv_bfloat16* __restrict__ sBh,
                                                 __nv_bfloat16* __restrict__ sBl,
                                                 const float* __restrict__ basis,
                                                 int tid) {
  for (int i = tid; i < BS * BS; i += THREADS) {
    const int k = i >> 6, m = i & 63;
    split_bf16(basis[i], sBh[k * BS + hcol(k, m)], sBl[k * BS + hcol(k, m)]);
  }
}

// xs = x / sf (a division, as the reference) of the thread's 4 x 4 samples
// of the raw tile (blocks 4*hi + bi, positions 4*lo .. 4*lo+3), in place one
// float4 of a block at a time (few values live across the divisions), then
// into the transposed tile. BLOCK_MAX: also each block's max |xs| into
// mx[b] (the 16 lo-threads of a half-warp per block; the whole warp calls).
// SPLIT (the relaxed analysis): into the bf16 hi and lo tiles, which take the
// raw buffer's own space (stage_split, after a barrier: a thread's tile
// bytes lie over other threads' samples); sT is not written.
template <bool BLOCK_MAX, bool SPLIT = false>
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
  if constexpr (SPLIT) {
    __syncthreads();  // every thread holds its samples
    __nv_bfloat16* sXh = reinterpret_cast<__nv_bfloat16*>(sRaw);
    stage_split(sXh, sXh + HT, hi, lo, v);
  } else {
    stage_transposed(sT, hi, lo, v);
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

// Four (two) 8 x 8 bf16 matrices from shared memory (ldmatrix): lanes 8i ..
// 8i+7 give the row addresses of matrix i, whose fragment lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// d += A (16 x 16, row-major) * B (16 x 8, column-major), bf16 in, float32
// accumulators, on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One bf16 product of the warp, from 0.f: d = the 16 x 8 tile of rows
// r0 .. r0+15 of sA ([block][m]) times columns n0 .. n0+7 of the basis tile
// sB ([k][m]), over m = 0..63 in four k16 steps (one n8 tile at a time:
// eight accumulators live in the two products being summed).
__device__ __forceinline__ void mma_pass(float (&d)[4],
                                         const __nv_bfloat16* __restrict__ sA,
                                         const __nv_bfloat16* __restrict__ sB,
                                         int r0, int n0, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
  // A: matrices (rows 0-7, m 0-7), (rows 8-15, m 0-7), (rows 0-7, m 8-15),
  // (rows 8-15, m 8-15); B: (k 0-7, m 0-7), (k 0-7, m 8-15), its b0, b1
  // (lanes 0-15 give the addresses)
  const int ar = r0 + (lane & 7) + ((lane >> 3) & 1) * 8, ac = (lane >> 4) * 8;
  const int br = n0 + (lane & 7), bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < BS / 16; ++ks) {
    unsigned a[4], b[2];
    ldmatrix_x2(b, sB + br * BS + hcol(br, 16 * ks + bc));
    ldmatrix_x4(a, sA + ar * BS + hcol(ar, 16 * ks + ac));
    mma_bf16(d, a, b[0], b[1]);
  }
}

// The forward product of the relaxed analysis: coef[b][k] = (d(xs_hi, B_lo)
// + d(xs_lo, B_hi)) + d(xs_hi, B_hi), the reference's order
// (dpk_fuse.py:469), each d its own accumulator. sXh, sXl: the staged
// sample tiles; sBh, sBl: the split basis. Warp w takes blocks 16*(w & 3)
// .. +15 and coefficients 32*(w >> 2) .. +31, one n8 tile at a time, and
// stores each into sC (the row layout, rcol) as soon as it has it.
// The whole CTA calls; it ends with a barrier, after which sC holds the tile
// and the sample tiles are free.
__device__ __forceinline__ void tile_product_bf16x3(
    const __nv_bfloat16* __restrict__ sXh, const __nv_bfloat16* __restrict__ sXl,
    const __nv_bfloat16* __restrict__ sBh, const __nv_bfloat16* __restrict__ sBl,
    float* __restrict__ sC, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * (warp & 3);
  // accumulator i of a thread: row g (i < 2) or g + 8, column 2*tg + (i & 1)
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    const int n0 = 32 * (warp >> 2) + 8 * t;
    float s[4], p[4];
    mma_pass(s, sXh, sBl, r0, n0, lane);
    mma_pass(p, sXl, sBh, r0, n0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = s[i] + p[i];
    mma_pass(p, sXh, sBh, r0, n0, lane);
    const int c = n0 + 2 * tg;
    const int ra = r0 + g, rb = ra + 8;
    *reinterpret_cast<float2*>(sC + ra * BS + rcol(ra, c)) =
        make_float2(s[0] + p[0], s[1] + p[1]);
    *reinterpret_cast<float2*>(sC + rb * BS + rcol(rb, c)) =
        make_float2(s[2] + p[2], s[3] + p[3]);
  }
  __syncthreads();
}

// acc[bi][ci] = coefficient 4*lo + ci of block 4*hi + bi from the coefficient
// tile sC (row layout): the thread's micro-tile, as tile_product leaves it.
__device__ __forceinline__ void load_micro_tile(const float* __restrict__ sC,
                                                int hi, int lo,
                                                float (&acc)[4][4]) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    const int b = 4 * hi + bi;
    const float4 v = ld4(sC + b * BS + rcol(b, 4 * lo));
    acc[bi][0] = v.x;
    acc[bi][1] = v.y;
    acc[bi][2] = v.z;
    acc[bi][3] = v.w;
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
