// Kernel D: bin centers, escapes and DC back to coefficients, the inverse DCT
// and the multiplication by the scaling factor.
//
// Replaces the dequantize/IDCT half of the TPU decode kernel
// dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 212-260, called from
// decode_fused). Plain version: the CPU branch of ops/dpk_fuse.dequant_idct
// (quantize.decode_dense + transform.block_idct).
//
// template <bool QT>: the QT instantiation inverts the renormalization of an
// AC escape through the container's qtable (held in shared memory) before
// the IDCT, ((v - side) / denom) * qtable[k] with the side taken from the
// sign of the stored value (dpk_fuse.py:212-218).
//
// What bounds it on the H100: 9 bytes in and 4 out per sample, 0.091 ms for
// 32Mi samples at 3.35 TB/s; the inverse DCT's 64 fmaf per sample, 0.064 ms
// at 67 TFLOP/s. The design (dct_tile.cuh):
// - A CTA of 256 threads takes a tile of 64 DCT blocks. It dequantizes (4
//   ids and a float4 of stored values per thread and row) straight into a
//   transposed coefficient tile, four blocks at one k per 16-byte load, then
//   runs the register-tiled product against the basis (16 independent
//   chains per thread, two 16-byte shared loads per 16 fmaf) and stores each
//   thread's four samples of a block with one 16-byte store.
// - The CTAs are persistent (CTAs-per-SM x SMs of them walk the tiles, so
//   the basis is loaded once per CTA) and load the next tile's ids and
//   stored values with cp.async while they transform this one, as kernel A
//   does: CTAs that start together stay in step, so without the prefetch
//   their loads and products would not overlap. 53.25 KB of shared memory
//   and __launch_bounds__(256, 4) (at most 64 registers) let four CTAs
//   share an SM.
// Every sample is fmaf(c[k], B[k][m], s) from 0.f over k = 0..63 in order,
// times sf, as common.cuh:inverse_dct computes it (kernel M_ref at tile 256
// decodes the same bits). No TF32 and no tensor cores.
//
// A container that stores its true length (the JAX package's XLA chain
// writes those) ends in a partial block of rem < 64 samples; the CTA that
// holds it then decodes that block again through the rem-point inverse DCT
// against tail_basis (rem x rem), one warp, as that chain decodes it, over
// the full-block result. The fused path stores the padded length, so rem is
// 0 there.

#include "dct_tile.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;

constexpr int MIN_CTAS = 4;  // resident CTAs per SM that __launch_bounds__ asks
// byte row of the raw id tile: 16-byte aligned for cp.async, and rows four
// apart fall on other banks
constexpr int LDI = 80;
// shared memory: basis, the transposed coefficient tile, the raw stored
// values, the qtable, the raw ids
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + 2 * TN + BS) + TB * LDI;

// Start loading tile t's ids and stored values into sIds / sAcv (block rows,
// as in device memory); zeros past nblk.
__device__ __forceinline__ void load_tile_async(float* __restrict__ sAcv,
                                                uint8_t* __restrict__ sIds,
                                                const uint8_t* __restrict__ ids,
                                                const float* __restrict__ acv,
                                                long long t, long long nblk,
                                                int tid) {
#pragma unroll
  for (int i = 0; i < TN / 4 / THREADS; ++i) {
    const int c = tid + i * THREADS, row = c >> 4, col = 4 * (c & 15);
    const long long gblk = t * TB + row;
    if (gblk < nblk)
      cp_async16(sAcv + row * BS + col, acv + gblk * BS + col);
    else
      st4(sAcv + row * BS + col, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  const int row = tid >> 2, col = 16 * (tid & 3);
  const long long gblk = t * TB + row;
  if (gblk < nblk)
    cp_async16(sIds + row * LDI + col, ids + gblk * BS + col);
  else
    *reinterpret_cast<uint4*>(sIds + row * LDI + col) = make_uint4(0, 0, 0, 0);
  cp_async_commit();
}

template <bool QT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    dequant_idct_kernel(const uint8_t* __restrict__ ids,
                        const float* __restrict__ acv,
                        const float* __restrict__ dc,
                        const float* __restrict__ basis,
                        const float* __restrict__ tail_basis,
                        const float* __restrict__ sf_p, long long nblk, int rem,
                        float w, const float* __restrict__ qtable, float rmin,
                        float rmax, float denom, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;           // basis B[k][m]
  float* sCT = sB + BS * BS;  // coefficients, transposed: row k, block column
  float* sAcv = sCT + TN;     // stored values as loaded
  float* sQ = sAcv + TN;      // qtable (QT only)
  uint8_t* sIds = reinterpret_cast<uint8_t*>(sQ + BS);  // ids as loaded

  const int tid = threadIdx.x, hi = tid >> 4, lo = tid & 15;
  const long long tiles = (nblk + TB - 1) / TB;
  const float sf = *sf_p;

  load_tile_async(sAcv, sIds, ids, acv, blockIdx.x, nblk, tid);
  for (int i = 4 * tid; i < BS * BS; i += 4 * THREADS)
    st4(sB + i, ld4(basis + i));
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
  }

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long blk0 = t * TB;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's readers are done

    // dequantize blocks 4*hi .. 4*hi+3 at k = 4*lo .. 4*lo+3
    {
      float v[4][4];
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        const int b = 4 * hi + bi;
        const long long gblk = blk0 + b;
        if (gblk < nblk) {
          const unsigned word =
              *reinterpret_cast<const unsigned*>(sIds + b * LDI + 4 * lo);
          const float4 a = ld4(sAcv + b * BS + 4 * lo);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int ki = 0; ki < 4; ++ki) {
            const int pos = 4 * lo + ki;
            const int id = (word >> (8 * ki)) & 0xff;
            float co;
            if (pos == 0)
              co = dc[gblk];
            else if (id == ESCAPE)
              co = QT ? qt_inverse(av[ki], sQ[pos], denom, rmin, rmax) : av[ki];
            else
              co = center_of(id, w);
            v[bi][ki] = co;
          }
        } else {
#pragma unroll
          for (int ki = 0; ki < 4; ++ki) v[bi][ki] = 0.f;
        }
      }
      stage_transposed(sCT, hi, lo, v);
    }
    __syncthreads();  // the tile is staged; the raw buffers are free
    if (t + gridDim.x < tiles)
      load_tile_async(sAcv, sIds, ids, acv, t + gridDim.x, nblk, tid);

    float acc[4][4];
    tile_product<false>(sCT, sB, hi, lo, acc);
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
      const long long gblk = blk0 + 4 * hi + bi;
      if (gblk < nblk)
        st4(out + gblk * BS + 4 * lo,
            make_float4(acc[bi][0] * sf, acc[bi][1] * sf, acc[bi][2] * sf,
                        acc[bi][3] * sf));
    }

    // the rem-point tail of a partial last block, over its full-block result
    if (rem != 0 && blk0 <= nblk - 1 && nblk - 1 < blk0 + TB) {
      __syncthreads();
      if (tid < 32) {
        const int b = static_cast<int>(nblk - 1 - blk0);
        for (int m = tid; m < rem; m += 32) {
          float s = 0.f;
          for (int k = 0; k < rem; ++k)
            s = fmaf(sCT[k * BS + tcol(k, b)], tail_basis[k * rem + m], s);
          out[(nblk - 1) * BS + m] = s * sf;
        }
      }
    }
  }
}

template <bool QT>
int launch(const uint8_t* ids, const float* acv, const float* dc,
           const float* basis, const float* tail_basis, const float* sf,
           long long nblk, int rem, float w, const float* qtable, float rmin,
           float rmax, float denom, float* out, void* stream) {
  static int cache[MAX_DEVICES] = {};
  const long long tiles = (nblk + TB - 1) / TB;
  if (tiles == 0) return 0;
  const long long grid =
      persistent_grid(dequant_idct_kernel<QT>, SMEM_BYTES, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  dequant_idct_kernel<QT>
      <<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
         static_cast<cudaStream_t>(stream)>>>(ids, acv, dc, basis, tail_basis,
                                              sf, nblk, rem, w, qtable, rmin,
                                              rmax, denom, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dctz_dequant_idct(const uint8_t* ids, const float* acv,
                                 const float* dc, const float* basis,
                                 const float* tail_basis, const float* sf,
                                 long long nblk, int rem, float w, float* out,
                                 void* stream) {
  return launch<false>(ids, acv, dc, basis, tail_basis, sf, nblk, rem, w,
                       nullptr, 0.f, 0.f, 1.f, out, stream);
}

extern "C" int dctz_dequant_idct_qt(const uint8_t* ids, const float* acv,
                                    const float* dc, const float* basis,
                                    const float* tail_basis, const float* sf,
                                    long long nblk, int rem, float w,
                                    const float* qtable, float rmin,
                                    float rmax, float denom, float* out,
                                    void* stream) {
  return launch<true>(ids, acv, dc, basis, tail_basis, sf, nblk, rem, w,
                      qtable, rmin, rmax, denom, out, stream);
}

extern "C" int dctz_ctas_per_sm_dequant_idct() {
  return dctz::tile::tile_ctas_per_sm(dequant_idct_kernel<false>, SMEM_BYTES);
}

extern "C" int dctz_ctas_per_sm_dequant_idct_qt() {
  return dctz::tile::tile_ctas_per_sm(dequant_idct_kernel<true>, SMEM_BYTES);
}
