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
// One CUDA block per 128 DCT blocks (8192 samples), one thread per DCT block.
// The samples are staged coalesced through shared memory (rows padded to 65
// floats) next to the 64x64 basis (16 KB, read as a broadcast). Each thread
// runs the scale and forward DCT of common.cuh (scale_block, forward_dct), as
// kernel E does; kernel A's tiled transform computes the same divisions and
// fmaf chains, so F's coefficients are bit-identical to A's. Each thread
// writes them over its own row; the block then bins them and stores ids and
// dcac coalesced. 49.5 KB of shared memory lets several blocks share an SM.
//
// What bounds it: 4 bytes in and 5 out per sample (302 MB at 32Mi samples,
// 0.090 ms at 3.35 TB/s) against 64 FMAs per sample (4.3 GFLOP, 0.064 ms at
// 67 TFLOP/s): bytes, in principle. The per-thread FMA chains of the forward
// DCT, as in E, are expected to keep it latency-bound instead (achieved
// occupancy not measured). No TF32: plain fp32 FMAs in index order, and x/sf
// and (v - rmin)/w are IEEE divisions (the build never uses --use_fast_math).

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int BPB = 128;         // DCT blocks per CUDA block
constexpr int TILE = BPB * BS;   // samples per CUDA block
constexpr int LD = 65;           // padded float row of the sample tile
// shared memory: basis, samples (overwritten by the coefficients), qtable
template <bool QT>
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + BPB * LD + (QT ? BS : 0));

template <bool QT>
__global__ void __launch_bounds__(BPB)
    dct_quant_kernel(const float* __restrict__ x,
                     const float* __restrict__ basis,
                     const float* __restrict__ sf_p,
                     const float* __restrict__ qtable, float eb, float qtf,
                     long long n_pad, float rmin, float rmax, float w,
                     uint8_t* __restrict__ ids_out,
                     float* __restrict__ dcac_out) {
  extern __shared__ float smem[];
  float* sB = smem;               // basis B[k][m]
  float* sX = sB + BS * BS;       // samples, then coefficients, block-major
  float* sQ = sX + BPB * LD;      // qtable (QT only)

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const float sf = *sf_p;

  for (int i = tid; i < BS * BS; i += BPB) sB[i] = basis[i];
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
  }
  for (int i = tid; i < TILE; i += BPB) {
    const long long gi = base + i;
    sX[(i >> 6) * LD + (i & 63)] = gi < n_pad ? x[gi] : 0.f;
  }
  __syncthreads();

  float* row = sX + tid * LD;
  float xs[BS];
  scale_block(row, sf, xs);
  forward_dct(xs, sB, [&](int k, float c) { row[k] = c; });
  __syncthreads();

  for (int i = tid; i < TILE; i += BPB) {
    const long long gi = base + i;
    if (gi >= n_pad) break;
    const int k = i & 63;
    const float c = sX[(i >> 6) * LD + k];
    int id = ESCAPE;
    float v = c;  // DC
    if (k > 0) {
      v = 0.f;
      if (c >= rmin && c <= rmax) {
        id = bin_of(c, rmin, w);
      } else if (QT) {
        const float side = c > rmax ? rmax : rmin;
        const float norm = __fadd_rn(
            __fmul_rn(__fmul_rn(__fdiv_rn(c, sQ[k]), eb), qtf), side);
        if (norm >= rmin && norm <= rmax)
          id = bin_of(norm, rmin, w);
        else
          v = norm;
      } else {
        v = c;
      }
    }
    ids_out[gi] = static_cast<uint8_t>(id);
    dcac_out[gi] = v;
  }
}

template <bool QT>
int launch(const float* x, const float* basis, const float* sf,
           const float* qtable, float eb, float qtf, long long n_pad,
           float rmin, float rmax, float w, uint8_t* ids, float* dcac,
           void* stream) {
  cudaFuncSetAttribute(dct_quant_kernel<QT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES<QT>));
  const long long grid = (n_pad + TILE - 1) / TILE;
  dct_quant_kernel<QT><<<static_cast<unsigned>(grid), BPB, SMEM_BYTES<QT>,
                         static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, qtable, eb, qtf, n_pad, rmin, rmax, w, ids, dcac);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dctz_dct_quant(const float* x, const float* basis,
                              const float* sf, long long n_pad, float rmin,
                              float rmax, float w, uint8_t* ids, float* dcac,
                              void* stream) {
  return launch<false>(x, basis, sf, nullptr, 0.f, 0.f, n_pad, rmin, rmax, w,
                       ids, dcac, stream);
}

extern "C" int dctz_dct_quant_qt(const float* x, const float* basis,
                                 const float* sf, const float* qtable,
                                 float eb, float qtf, long long n_pad,
                                 float rmin, float rmax, float w, uint8_t* ids,
                                 float* dcac, void* stream) {
  return launch<true>(x, basis, sf, qtable, eb, qtf, n_pad, rmin, rmax, w,
                      ids, dcac, stream);
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_dct_quant() { return dctz::ctas_per_sm(dct_quant_kernel<false>, BPB, SMEM_BYTES<false>); }
extern "C" int dctz_ctas_per_sm_dct_quant_qt() { return dctz::ctas_per_sm(dct_quant_kernel<true>, BPB, SMEM_BYTES<true>); }
