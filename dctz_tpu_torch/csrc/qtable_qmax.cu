// Kernel E: QT pass 1, the per-position max |escaped AC coefficient| of an
// array (the unclamped quantizer table).
//
// Replaces the TPU kernel dctz_tpu/ops/fused_encode.py:_qtable_pass (line 203,
// the _kernel_qmax program behind qtable_qmax, line 229). Plain version:
// ops/fused_encode.py:_qtable_qmax_plain.
//
// One CUDA block per 256-block DPK tile, one thread per DCT block: the
// tile's samples are staged coalesced through shared memory (rows padded to
// 65 floats) next to the 64x64 basis, and each thread runs
// common.cuh:forward_dct, the same fmaf chains as kernel A's tiled transform
// (dct_tile.cuh), so the maxima are taken over the very coefficients A bins. A
// coefficient at k > 0 outside [rmin, rmax] folds |c| into a shared per-
// position maximum, which one thread per position then folds into the (64,)
// global result, both with atomicMax on the int bits of the non-negative
// floats: exact and independent of order. The clamp to >= 1.0 is glue in the
// wrapper (ops/fused_encode.qtable_qmax).
//
// What bounds it: 64 FMAs per sample (4.3 GFLOP for 32Mi samples) against
// 128 MB read; at one or two blocks per SM the per-thread FMA chains are
// latency-bound.

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int LD = 65;
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + TILE_B * LD);

__global__ void __launch_bounds__(TILE_B)
    qtable_qmax_kernel(const float* __restrict__ x,
                       const float* __restrict__ basis,
                       const float* __restrict__ sf_p, long long n,
                       float rmin, float rmax, int* __restrict__ qmax_bits) {
  extern __shared__ float smem[];
  float* sB = smem;          // basis B[k][m]
  float* sX = sB + BS * BS;  // samples, block-major rows
  __shared__ int sM[BS];     // per-position max, as float bits

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * TILE_N;
  const float sf = *sf_p;

  for (int i = tid; i < BS * BS; i += TILE_B) sB[i] = basis[i];
  if (tid < BS) sM[tid] = 0;
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gi = base + i;
    sX[(i >> 6) * LD + (i & 63)] = gi < n ? x[gi] : 0.f;
  }
  __syncthreads();

  float xs[BS];
  scale_block(sX + tid * LD, sf, xs);
  forward_dct(xs, sB, [&](int k, float c) {
    if (k > 0 && !(c >= rmin && c <= rmax))
      atomicMax(&sM[k], __float_as_int(fabsf(c)));
  });
  __syncthreads();
  if (tid < BS && sM[tid] != 0) atomicMax(&qmax_bits[tid], sM[tid]);
}

}  // namespace

// qmax_bits: (64,) int32 zeroed by the caller; holds the float bits of the
// per-position maxima afterwards.
extern "C" int dctz_qtable_qmax(const float* x, const float* basis,
                                const float* sf, long long n, float rmin,
                                float rmax, int* qmax_bits, void* stream) {
  cudaFuncSetAttribute(qtable_qmax_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES));
  const long long tiles = (n + TILE_N - 1) / TILE_N;
  qtable_qmax_kernel<<<static_cast<unsigned>(tiles), TILE_B, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, n, rmin, rmax, qmax_bits);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_qtable_qmax() { return dctz::ctas_per_sm(qtable_qmax_kernel, TILE_B, SMEM_BYTES); }
