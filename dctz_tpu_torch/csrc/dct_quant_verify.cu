// Kernel A: scale, forward DCT, EC bin ids and the verify-repair passes.
//
// Replaces the transform/quantize/verify half of the TPU kernel
// dctz_tpu/ops/dpk_fuse.py:_make_encode_x_kernel (lines 494-647, called from
// encode_x_fused). Plain version: ops/dpk_fuse.py:_dct_quant_verify_plain.
//
// One CUDA block per DPK tile (256 DCT blocks, 16384 samples), one thread per
// DCT block. The tile's samples and coefficients sit in dynamic shared memory
// (2 x 66.5 KB, rows padded to 65 floats so the per-thread rows fall on
// distinct banks) with the 64x64 float32 basis (16 KB), which every thread
// reads at the same address (a broadcast). Global loads and stores are
// coalesced through shared memory.
//
// What bounds it: the forward DCT is 64 FMAs per sample (4.3 GFLOP for 32Mi
// samples) plus a reconstruct (another 64 FMAs per sample) for every block the
// L2 screen flags; against 128 MB read and 160 MB written. At one 256-thread
// block per SM (the shared memory allows no second) the FMA chains run with
// few warps to hide shared-memory latency, so latency rather than bandwidth is
// the expected bound (achieved occupancy not measured). Kept simple on
// purpose; tensor cores (wgmma) and fusing
// with kernel B are later work. No TF32: the sums are plain fp32 FMAs in
// index order, and x/sf and (v - rmin)/w are IEEE divisions (the build never
// uses --use_fast_math).
//
// The L2 screen gates the exact check per DCT block (the TPU kernel gates per
// tile); the screen is a rigorous bound, so which blocks are repaired does
// not depend on the gating granularity.

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int LD = 65;   // padded float row of the sample/coefficient tiles
constexpr int LDI = 68;  // padded byte row of the id tile
constexpr size_t SMEM_BYTES =
    sizeof(float) * (BS * BS + 2 * TILE_B * LD) + TILE_B * LDI;

struct Geom {
  float rmin, rmax, w, sf, tol;
};

// Max pointwise error of the block's reconstruction from its current ids.
// hat mirrors the decoder: DC and escapes read the coefficient, everything
// else its bin center. Also leaves hat[] for the repair's e_ij.
__device__ __forceinline__ float recon_err(const float* __restrict__ sB,
                                           const float* __restrict__ cr,
                                           const uint8_t* __restrict__ ir,
                                           const float* __restrict__ xr,
                                           long long gblk, long long n_pad,
                                           long long n_valid, const Geom& g,
                                           float (&hat)[BS]) {
#pragma unroll
  for (int k = 0; k < BS; ++k) {
    const float c = cr[k];
    const int id = ir[k];
    const bool acm = k > 0 && gblk + k < n_pad;
    hat[k] = (k == 0 || (acm && id == ESCAPE)) ? c : center_of(id, g.w);
  }
  float e = 0.f;
  for (int m = 0; m < BS; ++m) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < BS; ++k) s = fmaf(hat[k], sB[k * BS + m], s);
    const float xh = s * g.sf;
    if (gblk + m < n_valid) e = fmaxf(e, fabsf(xh - xr[m]));
  }
  return e;
}

__global__ void __launch_bounds__(TILE_B)
    dct_quant_verify_kernel(const float* __restrict__ x,
                            const float* __restrict__ basis,
                            const float* __restrict__ sf_p,
                            const float* __restrict__ tol_p, long long n_pad,
                            long long n_valid, float rmin, float rmax, float w,
                            int verify, uint8_t* __restrict__ ids_out,
                            float* __restrict__ coef_out,
                            int* __restrict__ ok_tiles) {
  extern __shared__ float smem[];
  float* sB = smem;                 // basis B[k][m]
  float* sX = sB + BS * BS;         // samples, block-major rows
  float* sC = sX + TILE_B * LD;     // coefficients
  uint8_t* sI = reinterpret_cast<uint8_t*>(sC + TILE_B * LD);  // bin ids

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * TILE_N;
  Geom g{rmin, rmax, w, *sf_p, *tol_p};

  for (int i = tid; i < BS * BS; i += TILE_B) sB[i] = basis[i];
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gi = base + i;
    sX[(i >> 6) * LD + (i & 63)] = gi < n_pad ? x[gi] : 0.f;
  }
  __syncthreads();

  const int b = tid;
  const long long gblk = base + static_cast<long long>(b) * BS;
  const float* xr = sX + b * LD;
  float* cr = sC + b * LD;
  uint8_t* ir = sI + b * LDI;

  // xs = x / sf (a division, as the reference), and the block's max |xs|
  float xs[BS];
  float mx = 0.f;
#pragma unroll
  for (int m = 0; m < BS; ++m) {
    xs[m] = xr[m] / g.sf;
    mx = fmaxf(mx, fabsf(xs[m]));
  }
  // forward DCT-II: coef[k] = sum_m xs[m] * B[k][m]
  for (int k = 0; k < BS; ++k) {
    float c = 0.f;
#pragma unroll
    for (int m = 0; m < BS; ++m) c = fmaf(xs[m], sB[k * BS + m], c);
    cr[k] = c;
  }
  // EC bins; DC and out-of-range coefficients escape
  float l2 = 0.f;
  for (int k = 0; k < BS; ++k) {
    const float c = cr[k];
    int id = ESCAPE;
    if (k > 0 && c >= g.rmin && c <= g.rmax) {
      int lin = __float2int_rz((c - g.rmin) / g.w);
      lin = min(max(lin, 0), NBINS - 1);
      id = zigzag_of_lin(lin);
    }
    ir[k] = static_cast<uint8_t>(id);
    const bool acm = k > 0 && gblk + k < n_pad;
    const float hat = (k == 0 || (acm && id == ESCAPE)) ? c : center_of(id, g.w);
    const float d = hat - c;
    l2 += d * d;
  }

  bool ok = true;
  if (verify) {
    // L2 screen: |IDCT(delta)_i| <= ||delta||_2 for the orthonormal basis,
    // minus a transform-rounding budget of 32 eps * max|xs|
    const float eps32 = 1.1920929e-07f;
    const float thr = g.tol / g.sf - 32.0f * eps32 * mx;
    if (l2 > thr * thr || thr <= 0.f) {
      float hat[BS];
      float blk = recon_err(sB, cr, ir, xr, gblk, n_pad, n_valid, g, hat);
      if (blk > g.tol) {
        const float floors[2] = {g.w / 8.0f, g.w * 1e-3f};
        for (int pass = 0; pass < 2; ++pass) {
          blk = recon_err(sB, cr, ir, xr, gblk, n_pad, n_valid, g, hat);
          if (blk > g.tol) {
#pragma unroll
            for (int k = 1; k < BS; ++k) {
              if (gblk + k < n_pad && fabsf(cr[k] - hat[k]) > floors[pass])
                ir[k] = ESCAPE;
            }
          }
        }
        blk = recon_err(sB, cr, ir, xr, gblk, n_pad, n_valid, g, hat);
        ok = !(blk > g.tol);
      }
    }
  }
  const int all_ok = __syncthreads_and(ok);
  if (tid == 0) ok_tiles[blockIdx.x] = all_ok;

  // streams: ids zeroed at DC and padding; the raw coefficients
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gi = base + i;
    if (gi < n_pad) {
      const int blk = i >> 6, k = i & 63;
      ids_out[gi] = k == 0 ? 0 : sI[blk * LDI + k];
      coef_out[gi] = sC[blk * LD + k];
    }
  }
}

}  // namespace

extern "C" int dctz_dct_quant_verify(const float* x, const float* basis,
                                     const float* sf, const float* tol,
                                     long long n_pad, long long n_valid,
                                     float rmin, float rmax, float w,
                                     int verify, uint8_t* ids, float* coef,
                                     int* ok_tiles, void* stream) {
  cudaFuncSetAttribute(dct_quant_verify_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES));
  const long long tiles = (n_pad + TILE_N - 1) / TILE_N;
  dct_quant_verify_kernel<<<static_cast<unsigned>(tiles), TILE_B, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, tol, n_pad, n_valid, rmin, rmax, w, verify, ids, coef,
      ok_tiles);
  return static_cast<int>(cudaGetLastError());
}
