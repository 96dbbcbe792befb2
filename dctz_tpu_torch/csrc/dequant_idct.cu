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
// One CUDA block per 256 DCT blocks, one thread per DCT block. Coefficients
// are built coalesced into dynamic shared memory (66.5 KB, rows padded to 65
// floats) next to the 64x64 float32 basis (16 KB, read as a broadcast); each
// thread holds its block's 64 coefficients in registers and writes its 64
// samples back over its own row, which the block then stores coalesced.
//
// A container that stores its true length (the JAX package's XLA chain
// writes those) ends in a partial block of rem < 64 samples; its thread runs
// the rem-point inverse DCT against tail_basis (rem x rem) instead, as that
// chain decodes it. The fused path stores the padded length, so rem is 0 there.
//
// What bounds it: 64 FMAs per sample (2.1 GFMA for 32Mi samples) against 9
// bytes in and 4 out per sample. The 82.5 KB of shared memory per block lets
// two 256-thread blocks share an SM (achieved occupancy not measured). No
// TF32 and no tensor cores: plain fp32 FMAs in index order.

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int LD = 65;
// shared memory: basis, coefficients, the qtable (QT only)
template <bool QT>
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + TILE_B * LD +
                                               (QT ? BS : 0));

template <bool QT>
__global__ void __launch_bounds__(TILE_B)
    dequant_idct_kernel(const uint8_t* __restrict__ ids,
                        const float* __restrict__ acv,
                        const float* __restrict__ dc,
                        const float* __restrict__ basis,
                        const float* __restrict__ tail_basis,
                        const float* __restrict__ sf_p, long long nblk, int rem,
                        float w, const float* __restrict__ qtable, float rmin,
                        float rmax, float denom, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sB = smem;
  float* sC = sB + BS * BS;
  float* sQ = sC + TILE_B * LD;  // qtable (QT only)

  const int tid = threadIdx.x;
  const long long blk0 = static_cast<long long>(blockIdx.x) * TILE_B;
  const float sf = *sf_p;

  for (int i = tid; i < BS * BS; i += TILE_B) sB[i] = basis[i];
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
    __syncthreads();
  }
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const int blk = i >> 6, pos = i & 63;
    const long long gblk = blk0 + blk;
    float co = 0.f;
    if (gblk < nblk) {
      const long long gi = gblk * BS + pos;
      const int id = ids[gi];
      if (pos == 0)
        co = dc[gblk];
      else if (id == ESCAPE)
        co = QT ? qt_inverse(acv[gi], sQ[pos], denom, rmin, rmax) : acv[gi];
      else
        co = center_of(id, w);
    }
    sC[blk * LD + pos] = co;
  }
  __syncthreads();

  float* cr = sC + tid * LD;
  float c[BS];
#pragma unroll
  for (int k = 0; k < BS; ++k) c[k] = cr[k];
  if (rem != 0 && blk0 + tid == nblk - 1) {
    for (int m = 0; m < rem; ++m) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < BS; ++k)
        if (k < rem) s = fmaf(c[k], tail_basis[k * rem + m], s);
      cr[m] = s * sf;
    }
  } else {
    inverse_dct(c, sB, sf, cr);
  }
  __syncthreads();

  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gblk = blk0 + (i >> 6);
    if (gblk < nblk) out[gblk * BS + (i & 63)] = sC[(i >> 6) * LD + (i & 63)];
  }
}

template <bool QT>
int launch(const uint8_t* ids, const float* acv, const float* dc,
           const float* basis, const float* tail_basis, const float* sf,
           long long nblk, int rem, float w, const float* qtable, float rmin,
           float rmax, float denom, float* out, void* stream) {
  cudaFuncSetAttribute(dequant_idct_kernel<QT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES<QT>));
  const long long grid = (nblk + TILE_B - 1) / TILE_B;
  dequant_idct_kernel<QT>
      <<<static_cast<unsigned>(grid), TILE_B, SMEM_BYTES<QT>,
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
