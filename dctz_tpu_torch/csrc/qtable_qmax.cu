// Kernel E: QT pass 1, the per-position max |escaped AC coefficient| of an
// array (the unclamped quantizer table).
//
// Replaces the TPU kernel dctz_tpu/ops/fused_encode.py:_qtable_pass (line 203,
// the _kernel_qmax program behind qtable_qmax, line 229). Plain version:
// ops/fused_encode.py:_qtable_qmax_plain.
//
// What bounds it on the H100: it only reads, 128 MB for 32Mi samples (0.040
// ms at 3.35 TB/s), against the forward DCT's 64 fmaf per sample (0.064 ms
// at 67 TFLOP/s): operations. So the design is kernel A's front end with no
// stores (dct_tile.cuh):
// - A CTA of 256 threads takes a tile of 64 DCT blocks: the register-tiled
//   product, 16 independent chains per thread. 48.25 KB of shared memory and
//   __launch_bounds__(256, 4) (at most 64 registers) let four CTAs share an
//   SM.
// - The CTAs are persistent and load the next tile with cp.async into the
//   raw buffer while they transform this one (load_tile_async); xs = x / sf
//   is an IEEE division staged into the transposed tile (stage_scaled).
// - The epilogue keeps the tile loop free of shared memory and atomics:
//   thread (hi, lo) holds 4 running maxima in registers, one for each of its
//   positions k = 4*lo .. 4*lo+3, over its 4 blocks of every tile it walks,
//   folding in |c| where k > 0 and c is outside [rmin, rmax]. After the last
//   tile, lanes lo and lo + 16 (same positions) fold by one shuffle, the
//   warps through a 64-int shared array, and each CTA folds that into the
//   (64,) global result with one atomicMax per position, all on the int bits
//   of the non-negative floats: exact and independent of order.
//
// Bit-exactness: the coefficients are those of kernel A (the same staging,
// basis layout and fmaf chains of dct_tile.cuh), so the maxima are taken
// over the very coefficients A bins; kernel L_ref's per-thread transform
// (common.cuh:forward_dct) is the independent check of that header. Zero
// padding past n_pad (load_tile_async fills zeros) bins in range and adds
// nothing. The clamp to >= 1.0 is glue in the wrapper
// (ops/fused_encode.qtable_qmax).
//
// template <bool RELAXED>: the relaxed analysis (dct_precision "high", the
// TPU kernel's _make_kernel_qmax(relaxed), fused_encode.py:122-131): the
// product is dct_tile.cuh:tile_product_bf16x3, three bfloat16 products on
// the tensor cores, whose coefficients each thread reads back from the
// coefficient tile; the bf16 basis tiles take the transposed basis's space,
// the bf16 sample tiles the raw buffer's (the next tile's loads start after
// the product) and the coefficients the transposed tile's, so the shared
// memory and the 4 CTAs per SM stay. The maxima are again those of the
// coefficients A's RELAXED instantiation bins.

#include "dct_tile.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;

constexpr int MIN_CTAS = 4;  // resident CTAs per SM that __launch_bounds__ asks
// shared memory: transposed basis, raw samples, the transposed sample tile,
// the CTA's per-position maxima
constexpr size_t SMEM_BYTES = sizeof(float) * 3 * TN + sizeof(int) * BS;

// Fold the escaping coefficients of the thread's 4 x 4 micro-tile into its
// running maxima mb[ci] of positions k = 4*lo + ci (float bits; an int max
// on the bits of non-negative floats is their max, NaN above every number).
__device__ __forceinline__ void fold_escapes(const float (&acc)[4][4], int lo,
                                             float rmin, float rmax,
                                             int (&mb)[4]) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const float c = acc[bi][ci];
      if (4 * lo + ci > 0 && !(c >= rmin && c <= rmax))
        mb[ci] = max(mb[ci], __float_as_int(fabsf(c)));
    }
}

template <bool RELAXED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    qtable_qmax_kernel(const float* __restrict__ x,
                       const float* __restrict__ basis,
                       const float* __restrict__ sf_p, long long n_pad,
                       float rmin, float rmax, int* __restrict__ qmax_bits) {
  extern __shared__ __align__(16) float smem[];
  float* sBT = smem;       // basis, row m holds B[k][m] at rcol(m, k)
  float* sRaw = sBT + TN;  // samples as loaded, block-major
  float* sT = sRaw + TN;   // xs transposed
  int* sM = reinterpret_cast<int*>(sT + TN);  // per-position max, float bits
  // RELAXED: the bf16 basis tiles in sBT's space, the bf16 sample tiles in
  // sRaw's, the coefficient tile in sT's
  __nv_bfloat16* sBh = reinterpret_cast<__nv_bfloat16*>(sBT);
  const __nv_bfloat16* sXh = reinterpret_cast<const __nv_bfloat16*>(sRaw);

  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const long long tiles = (n_pad + TN - 1) / TN;
  const float sf = *sf_p;

  long long t = blockIdx.x;
  load_tile_async(sRaw, x, t, n_pad, tid);
  if constexpr (RELAXED)
    load_basis_split(sBh, sBh + HT, basis, tid);
  else
    load_basis_transposed(sBT, basis, tid);
  if (tid < BS) sM[tid] = 0;

  int mb[4] = {0, 0, 0, 0};
  for (; t < tiles; t += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's readers are done
    stage_scaled<false, RELAXED>(sRaw, sT, sf, hi, lo, nullptr);
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
    fold_escapes(acc, lo, rmin, rmax, mb);
  }

  // lanes lo and lo + 16 of a warp hold the same positions
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) mb[ci] = max(mb[ci], __shfl_xor_sync(FULL, mb[ci], 16));
  if ((tid & 16) == 0) {
#pragma unroll
    for (int ci = 0; ci < 4; ++ci)
      if (mb[ci] != 0) atomicMax(&sM[4 * lo + ci], mb[ci]);
  }
  __syncthreads();
  if (tid < BS && sM[tid] != 0) atomicMax(&qmax_bits[tid], sM[tid]);
}

template <bool RELAXED>
int launch(const float* x, const float* basis, const float* sf, long long n,
           float rmin, float rmax, int* qmax_bits, void* stream) {
  static int cache[MAX_DEVICES] = {};
  const long long tiles = (n + TN - 1) / TN;
  if (tiles == 0) return 0;
  const long long grid =
      persistent_grid(qtable_qmax_kernel<RELAXED>, SMEM_BYTES, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  qtable_qmax_kernel<RELAXED><<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, n, rmin, rmax, qmax_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qmax_bits: (64,) int32 zeroed by the caller; holds the float bits of the
// per-position maxima afterwards. x: n (a multiple of 1024) floats on 16
// bytes.
extern "C" int dctz_qtable_qmax(const float* x, const float* basis,
                                const float* sf, long long n, float rmin,
                                float rmax, int* qmax_bits, void* stream) {
  return launch<false>(x, basis, sf, n, rmin, rmax, qmax_bits, stream);
}

extern "C" int dctz_qtable_qmax_relaxed(const float* x, const float* basis,
                                        const float* sf, long long n,
                                        float rmin, float rmax, int* qmax_bits,
                                        void* stream) {
  return launch<true>(x, basis, sf, n, rmin, rmax, qmax_bits, stream);
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_qtable_qmax() {
  return dctz::tile::tile_ctas_per_sm(qtable_qmax_kernel<false>, SMEM_BYTES);
}
extern "C" int dctz_ctas_per_sm_qtable_qmax_relaxed() {
  return dctz::tile::tile_ctas_per_sm(qtable_qmax_kernel<true>, SMEM_BYTES);
}
