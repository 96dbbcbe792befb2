// Shared geometry and helpers of the DPK kernels (see ops/dpk_fuse.py).
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

// Zigzag bin id of an in-range value v: (v - rmin) / w truncated, clamped to
// the bins (kernel L_ref; the tiled kernels bin through dct_tile.cuh:ac_bin).
__device__ __forceinline__ int bin_of(float v, float rmin, float w) {
  int lin = __float2int_rz((v - rmin) / w);
  lin = min(max(lin, 0), NBINS - 1);
  return zigzag_of_lin(lin);
}

// xs[m] = xr[m] / sf (a division, as the reference); returns max |xs|.
__device__ __forceinline__ float scale_block(const float* __restrict__ xr,
                                            float sf, float (&xs)[BS]) {
  float mx = 0.f;
#pragma unroll
  for (int m = 0; m < BS; ++m) {
    xs[m] = xr[m] / sf;
    mx = fmaxf(mx, fabsf(xs[m]));
  }
  return mx;
}

// Forward DCT-II of one block, coef[k] = sum_m xs[m] * B[k][m] as an fmaf
// chain in index order, handed to emit(k, coef[k]). Kernel L_ref runs it; the
// tiled transform of kernels A, E, F and G (dct_tile.cuh) computes the same
// chains, so L = F -> pack_ids -> H holds that header against this one.
template <class Emit>
__device__ __forceinline__ void forward_dct(const float (&xs)[BS],
                                            const float* __restrict__ sB,
                                            Emit&& emit) {
  for (int k = 0; k < BS; ++k) {
    float c = 0.f;
#pragma unroll
    for (int m = 0; m < BS; ++m) c = fmaf(xs[m], sB[k * BS + m], c);
    emit(k, c);
  }
}

// Inverse DCT of one block held in registers, written over its shared-memory
// row: cr[m] = (sum_k c[k] * B[k][m]) * sf, an fmaf chain in index order.
// Kernel M_ref runs it; kernel D's tiled transform (dct_tile.cuh) computes the
// same chains, so M at tile 256 decodes C+D's bits.
__device__ __forceinline__ void inverse_dct(const float (&c)[BS],
                                            const float* __restrict__ sB,
                                            float sf, float* __restrict__ cr) {
  for (int m = 0; m < BS; ++m) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < BS; ++k) s = fmaf(c[k], sB[k * BS + m], s);
    cr[m] = s * sf;
  }
}

// QT renormalization of an escape, ((c / q) * eb) * qtf + side with the side
// chosen by sign, and its inverse ((v - side) / denom) * q. Each step is an
// explicitly rounded IEEE operation: nvcc would otherwise contract the
// multiply-add into an FMA, which rounds differently from the TPU kernel and
// the plain version (and so shifts the stored bytes).
__device__ __forceinline__ float qt_renorm(float c, float q, float eb,
                                           float qtf, float rmin, float rmax) {
  const float side = c > 0.f ? rmax : rmin;
  return __fadd_rn(__fmul_rn(__fmul_rn(__fdiv_rn(c, q), eb), qtf), side);
}

__device__ __forceinline__ float qt_inverse(float v, float q, float denom,
                                            float rmin, float rmax) {
  const float side = v > 0.f ? rmax : rmin;
  return __fmul_rn(__fdiv_rn(__fsub_rn(v, side), denom), q);
}

// Lanes below this one, for ballot prefix counts.
__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Resident CTAs per SM of a kernel at a launch configuration
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on an error. Dynamic
// shared memory above 48 KB is allowed for the kernel first, as its launch
// does.
template <class Kernel>
int ctas_per_sm(Kernel kernel, int threads, size_t smem) {
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace dctz
