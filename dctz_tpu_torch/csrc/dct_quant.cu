// Kernels F and G: scale, forward DCT, bin ids and the escaped values of the
// non-DPK fused encode.
//
// Replaces the TPU kernels dctz_tpu/ops/fused_encode.py:fused_encode_ec (F,
// pallas_call at line 363, body _make_kernel lines 93-116) and the pass-2
// program of fused_encode_qt (G, pallas_call at line 294, body
// _kernel_qt_body lines 161-197). Plain version:
// ops/fused_encode.py:_dct_quant_plain.
//
// Contract, per sample of the zero-padded input (n_pad a multiple of 1024):
//   ids  u8:  ESCAPE at each block's DC and at every AC coefficient that is
//             out of range (G: still out of range after the renormalization),
//             else its zigzag bin; padding is binned like data;
//   dcac f32: the DC coefficient at column 0, the stored value at an AC escape
//             (F: the coefficient; G: ((c/q)*eb)*qtf + side), 0 elsewhere.
// template <bool QT>: G renormalizes an out-of-range AC coefficient through
// the qtable (kernel E's output, held in shared memory) and re-bins it if it
// lands in range. The side is picked with c > rmax, the TPU kernel's
// expression (the DPK kernel A picks it by sign; the two agree on every value
// that is stored). The renormalization is written with IEEE intrinsics so
// nvcc cannot contract it into an FMA (common.cuh:qt_renorm says why).
//
// What bounds it on the H100: 4 bytes in and 5 out per sample (302 MB at
// 32Mi samples, 0.090 ms at 3.35 TB/s) against 64 fmaf per sample (4.3
// GFLOP, 0.064 ms at 67 TFLOP/s): bytes, with the operations close behind.
// So the design is kernel A's front end without the verify (dct_tile.cuh):
// - A CTA of 256 threads takes a tile of 64 DCT blocks: the register-tiled
//   product, 16 independent chains per thread. 48.25 KB of shared memory and
//   __launch_bounds__(256, 4) (at most 64 registers) let four CTAs share an
//   SM.
// - The CTAs are persistent and load the next tile with cp.async into the
//   raw buffer while they transform this one (load_tile_async); xs = x / sf
//   is an IEEE division staged into the transposed tile (stage_scaled).
// - The epilogue bins each thread's 4 x 4 coefficients straight from its
//   accumulators (A's ac_bin, G's renormalization) and stores 16 bytes at a
//   time: a float4 of dcac per block and position group, and, after the 4
//   lanes of a position quad trade their id words by shuffles, one uint4 of
//   16 ids per lane. Blocks past n_pad are not written (the last tile is
//   partial when n_pad is not a multiple of 4096).
//
// Bit-exactness: the coefficients are those of kernel A (the same staging,
// basis layout and fmaf chains of dct_tile.cuh), so F equals A with verify
// off at every AC id and at the DC and the escapes, and G equals A-QT;
// kernel L_ref's per-thread transform (common.cuh:forward_dct) is the
// independent check of that header (L_ref = F -> pack_ids -> H). No TF32 and no
// --use_fast_math: x/sf and (v - rmin)/w are IEEE divisions.
//
// template <bool RELAXED>: the relaxed analysis (dct_precision "high", the
// TPU kernels' _make_kernel(relaxed) and _make_kernel_qt(relaxed),
// fused_encode.py:92-103 and :148-173): the product is
// dct_tile.cuh:tile_product_bf16x3, three bfloat16 products on the tensor
// cores, whose coefficients each thread reads back from the coefficient tile
// before the same epilogue; the bf16 basis tiles take the transposed basis's
// space, the bf16 sample tiles the raw buffer's (the next tile's loads start
// after the product) and the coefficients the transposed tile's, so the
// shared memory and the 4 CTAs per SM stay. F and G RELAXED equal A's
// RELAXED instantiations as F and G equal A.

#include "dct_tile.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;

constexpr int MIN_CTAS = 4;  // resident CTAs per SM that __launch_bounds__ asks
// shared memory: transposed basis, raw samples, the transposed sample tile,
// the qtable (G)
constexpr size_t SMEM_BYTES = sizeof(float) * (3 * TN + BS);

// Id of coefficient c at position k of a block, and its dcac value in v: DC
// escapes and keeps c; an AC coefficient in range takes its bin and 0; one
// out of range escapes with c (F) or, G, is renormalized through q and takes
// the bin of that if it lands in range, else escapes with it.
template <bool QT>
__device__ __forceinline__ int bin_and_value(int k, float c, float q,
                                             const Geom& g, float& v) {
  if (k == 0) {
    v = c;
    return ESCAPE;
  }
  int id = ac_bin<false>(c, 0.f, g);
  v = id == ESCAPE ? c : 0.f;
  if constexpr (QT) {
    if (id == ESCAPE) {
      const float side = c > g.rmax ? g.rmax : g.rmin;
      const float norm =
          __fadd_rn(__fmul_rn(__fmul_rn(__fdiv_rn(c, q), g.eb), g.qtf), side);
      id = ac_bin<false>(norm, 0.f, g);
      v = id == ESCAPE ? norm : 0.f;
    }
  }
  return id;
}

// w[s] when s is a runtime index (selects, not a local-memory array).
__device__ __forceinline__ unsigned pick(const unsigned (&w)[4], int s) {
  return s == 0 ? w[0] : s == 1 ? w[1] : s == 2 ? w[2] : w[3];
}

// The epilogue of tile `base`: the bins and values of blocks 4*hi + bi at
// positions 4*lo .. 4*lo+3, dcac as a float4 each, the ids as a word each;
// then lanes 4j .. 4j+3, which hold positions 16j .. 16j+15 of the same 4
// blocks, trade their words so that lane 4j + r holds those 16 ids of block
// 4*hi + r (word s from lane 4j + s, which sent its word for block r), and
// store them as one uint4. Blocks past n_pad are not written.
template <bool QT>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4],
                                           long long base, int hi, int lo,
                                           long long n_pad,
                                           const float* __restrict__ sQ,
                                           const Geom& g,
                                           uint8_t* __restrict__ ids_out,
                                           float* __restrict__ dcac_out) {
  unsigned wd[4];
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    float v[4];
    unsigned word = 0;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const int k = 4 * lo + ci;
      const int id = bin_and_value<QT>(k, acc[bi][ci], QT ? sQ[k] : 0.f, g, v[ci]);
      word |= static_cast<unsigned>(id) << (8 * ci);
    }
    wd[bi] = word;
    const long long gi = base + (4 * hi + bi) * BS + 4 * lo;
    if (gi < n_pad) st4(dcac_out + gi, make_float4(v[0], v[1], v[2], v[3]));
  }
  const int r = lo & 3;
  unsigned got[4];
  got[0] = pick(wd, r);
#pragma unroll
  for (int s = 1; s < 4; ++s) got[s] = __shfl_xor_sync(FULL, pick(wd, r ^ s), s);
  const long long gi = base + (4 * hi + r) * BS + 16 * (lo >> 2);
  if (gi < n_pad)
    *reinterpret_cast<uint4*>(ids_out + gi) =
        make_uint4(pick(got, r), pick(got, r ^ 1), pick(got, r ^ 2), pick(got, r ^ 3));
}

template <bool QT, bool RELAXED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    dct_quant_kernel(const float* __restrict__ x,
                     const float* __restrict__ basis,
                     const float* __restrict__ sf_p,
                     const float* __restrict__ qtable, float eb, float qtf,
                     long long n_pad, float rmin, float rmax, float w,
                     uint8_t* __restrict__ ids_out,
                     float* __restrict__ dcac_out) {
  extern __shared__ __align__(16) float smem[];
  float* sBT = smem;       // basis, row m holds B[k][m] at rcol(m, k)
  float* sRaw = sBT + TN;  // samples as loaded, block-major
  float* sT = sRaw + TN;   // xs transposed
  float* sQ = sT + TN;     // qtable (G)
  // RELAXED: the bf16 basis tiles in sBT's space, the bf16 sample tiles in
  // sRaw's, the coefficient tile in sT's
  __nv_bfloat16* sBh = reinterpret_cast<__nv_bfloat16*>(sBT);
  const __nv_bfloat16* sXh = reinterpret_cast<const __nv_bfloat16*>(sRaw);

  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const long long tiles = (n_pad + TN - 1) / TN;
  const Geom g{rmin, rmax, w, *sf_p, 0.f, eb, qtf, 0.f};

  long long t = blockIdx.x;
  load_tile_async(sRaw, x, t, n_pad, tid);
  if constexpr (RELAXED)
    load_basis_split(sBh, sBh + HT, basis, tid);
  else
    load_basis_transposed(sBT, basis, tid);
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
  }

  for (; t < tiles; t += gridDim.x) {
    const long long base = t * TN;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's readers are done
    stage_scaled<false, RELAXED>(sRaw, sT, g.sf, hi, lo, nullptr);
    __syncthreads();  // the tile is staged; sRaw is free (RELAXED: after the product)
    if (!RELAXED && t + gridDim.x < tiles)
      load_tile_async(sRaw, x, t + gridDim.x, n_pad, tid);

    float acc[4][4];
    if constexpr (RELAXED) {
      tile_product_bf16x3(sXh, sXh + HT, sBh, sBh + HT, sT, tid);
      if (t + gridDim.x < tiles) load_tile_async(sRaw, x, t + gridDim.x, n_pad, tid);
      load_micro_tile(sT, hi, lo, acc);
    } else {
      tile_product<true>(sT, sBT, hi, lo, acc);
    }
    store_tile<QT>(acc, base, hi, lo, n_pad, sQ, g, ids_out, dcac_out);
  }
}

template <bool QT, bool RELAXED>
int launch(const float* x, const float* basis, const float* sf,
           const float* qtable, float eb, float qtf, long long n_pad,
           float rmin, float rmax, float w, uint8_t* ids, float* dcac,
           void* stream) {
  static int cache[MAX_DEVICES] = {};
  const long long tiles = (n_pad + TN - 1) / TN;
  if (tiles == 0) return 0;
  const long long grid =
      persistent_grid(dct_quant_kernel<QT, RELAXED>, SMEM_BYTES, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  dct_quant_kernel<QT, RELAXED><<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
                                  static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, qtable, eb, qtf, n_pad, rmin, rmax, w, ids, dcac);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points: F and G, each in its HIGHEST and RELAXED
// instantiation. x: n_pad (a multiple of 1024) floats on 16 bytes.
#define DCTZ_F_ENTRY(NAME, RELAXED)                                            \
  extern "C" int NAME(const float* x, const float* basis, const float* sf,   \
                      long long n_pad, float rmin, float rmax, float w,      \
                      uint8_t* ids, float* dcac, void* stream) {             \
    return launch<false, RELAXED>(x, basis, sf, nullptr, 0.f, 0.f, n_pad,    \
                                  rmin, rmax, w, ids, dcac, stream);         \
  }
#define DCTZ_G_ENTRY(NAME, RELAXED)                                            \
  extern "C" int NAME(const float* x, const float* basis, const float* sf,   \
                      const float* qtable, float eb, float qtf,              \
                      long long n_pad, float rmin, float rmax, float w,      \
                      uint8_t* ids, float* dcac, void* stream) {             \
    return launch<true, RELAXED>(x, basis, sf, qtable, eb, qtf, n_pad, rmin, \
                                 rmax, w, ids, dcac, stream);                \
  }

DCTZ_F_ENTRY(dctz_dct_quant, false)
DCTZ_F_ENTRY(dctz_dct_quant_relaxed, true)
DCTZ_G_ENTRY(dctz_dct_quant_qt, false)
DCTZ_G_ENTRY(dctz_dct_quant_qt_relaxed, true)

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_dct_quant() {
  return dctz::tile::tile_ctas_per_sm(dct_quant_kernel<false, false>, SMEM_BYTES);
}
extern "C" int dctz_ctas_per_sm_dct_quant_qt() {
  return dctz::tile::tile_ctas_per_sm(dct_quant_kernel<true, false>, SMEM_BYTES);
}
extern "C" int dctz_ctas_per_sm_dct_quant_relaxed() {
  return dctz::tile::tile_ctas_per_sm(dct_quant_kernel<false, true>, SMEM_BYTES);
}
extern "C" int dctz_ctas_per_sm_dct_quant_qt_relaxed() {
  return dctz::tile::tile_ctas_per_sm(dct_quant_kernel<true, true>, SMEM_BYTES);
}
