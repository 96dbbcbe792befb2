// Kernel A: scale, forward DCT, EC/QT bin ids and the verify-repair passes.
//
// Replaces the transform/quantize/verify half of the TPU kernel
// dctz_tpu/ops/dpk_fuse.py:_make_encode_x_kernel (lines 494-647, called from
// encode_x_fused). Plain version: ops/dpk_fuse.py:_dct_quant_verify_plain.
//
// template <bool QT>: the EC instantiation stores an escape as the
// coefficient itself. The QT instantiation (the qt branches at
// dpk_fuse.py:534-547,560-564,685-687) renormalizes an out-of-range AC
// coefficient through the qtable (held in shared memory), re-bins it if it
// lands in range, reconstructs an escape through the inverse as the decoder
// does, raises the repair floor to 3e-6 * |qtable[k]|, and writes the stored
// (renormalized) values in place of the coefficients at AC escapes.
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
// shared memory: basis, samples, coefficients, the qtable (QT only), ids
template <bool QT>
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + 2 * TILE_B * LD +
                                               (QT ? BS : 0)) +
                              TILE_B * LDI;

struct Geom {
  float rmin, rmax, w, sf, tol;
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

// The decoder's coefficient at position k > 0 of a block: an escape reads
// its stored value (EC: the coefficient; QT: the renormalized value, inverted
// as the decoder inverts it), everything else its bin center.
template <bool QT>
__device__ __forceinline__ float hat_of(float c, int id, bool acm, float q,
                                        const Geom& g) {
  if (!(acm && id == ESCAPE)) return center_of(id, g.w);
  if constexpr (QT)
    return qt_inverse(qt_renorm(c, q, g.eb, g.qtf, g.rmin, g.rmax), q, g.denom,
                      g.rmin, g.rmax);
  return c;
}

// Max pointwise error of the block's reconstruction from its current ids.
// hat mirrors the decoder (DC reads the coefficient, hat_of for the rest).
// Also leaves hat[] for the repair's e_ij.
template <bool QT>
__device__ __forceinline__ float recon_err(const float* __restrict__ sB,
                                           const float* __restrict__ cr,
                                           const uint8_t* __restrict__ ir,
                                           const float* __restrict__ sQ,
                                           const float* __restrict__ xr,
                                           long long gblk, long long n_pad,
                                           long long n_valid, const Geom& g,
                                           float (&hat)[BS]) {
#pragma unroll
  for (int k = 0; k < BS; ++k) {
    const float c = cr[k];
    const int id = ir[k];
    const bool acm = k > 0 && gblk + k < n_pad;
    hat[k] = k == 0 ? c : hat_of<QT>(c, id, acm, QT ? sQ[k] : 0.f, g);
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

template <bool QT>
__global__ void __launch_bounds__(TILE_B)
    dct_quant_verify_kernel(const float* __restrict__ x,
                            const float* __restrict__ basis,
                            const float* __restrict__ sf_p,
                            const float* __restrict__ tol_p,
                            const float* __restrict__ qtable, float eb,
                            float qtf, long long n_pad, long long n_valid,
                            float rmin, float rmax, float w, int verify,
                            uint8_t* __restrict__ ids_out,
                            float* __restrict__ vals_out,
                            int* __restrict__ ok_tiles) {
  extern __shared__ float smem[];
  float* sB = smem;                 // basis B[k][m]
  float* sX = sB + BS * BS;         // samples, block-major rows
  float* sC = sX + TILE_B * LD;     // coefficients
  float* sQ = sC + TILE_B * LD;     // qtable (QT only)
  uint8_t* sI = reinterpret_cast<uint8_t*>(sQ + (QT ? BS : 0));  // bin ids

  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * TILE_N;
  Geom g{rmin, rmax, w, *sf_p, *tol_p, eb, qtf, __fmul_rn(eb, qtf)};

  for (int i = tid; i < BS * BS; i += TILE_B) sB[i] = basis[i];
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
  }
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

  // xs = x / sf (a division, as the reference), the block's max |xs|, and
  // the forward DCT-II
  float xs[BS];
  const float mx = scale_block(xr, g.sf, xs);
  forward_dct(xs, sB, [&](int k, float c) { cr[k] = c; });
  // bins; DC and what stays out of range escape
  float l2 = 0.f;
  for (int k = 0; k < BS; ++k) {
    const float c = cr[k];
    const float q = QT ? sQ[k] : 0.f;
    const int id = k > 0 ? ac_bin<QT>(c, q, g) : ESCAPE;
    ir[k] = static_cast<uint8_t>(id);
    const bool acm = k > 0 && gblk + k < n_pad;
    const float hat = k == 0 ? c : hat_of<QT>(c, id, acm, q, g);
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
      float blk =
          recon_err<QT>(sB, cr, ir, sQ, xr, gblk, n_pad, n_valid, g, hat);
      if (blk > g.tol) {
        const float floors[2] = {g.w / 8.0f, g.w * 1e-3f};
        for (int pass = 0; pass < 2; ++pass) {
          blk = recon_err<QT>(sB, cr, ir, sQ, xr, gblk, n_pad, n_valid, g, hat);
          if (blk > g.tol) {
#pragma unroll
            for (int k = 1; k < BS; ++k) {
              // QT: an escape carries ~1.5e-6 * qtable[k] of error itself
              const float floor =
                  QT ? fmaxf(floors[pass], __fmul_rn(3e-6f, fabsf(sQ[k])))
                     : floors[pass];
              if (gblk + k < n_pad && fabsf(cr[k] - hat[k]) > floor)
                ir[k] = ESCAPE;
            }
          }
        }
        blk = recon_err<QT>(sB, cr, ir, sQ, xr, gblk, n_pad, n_valid, g, hat);
        ok = !(blk > g.tol);
      }
    }
  }
  const int all_ok = __syncthreads_and(ok);
  if (tid == 0) ok_tiles[blockIdx.x] = all_ok;

  // streams: ids zeroed at DC and padding; the coefficients, except QT's AC
  // escapes, which store their renormalized values
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gi = base + i;
    if (gi < n_pad) {
      const int blk = i >> 6, k = i & 63;
      const int id = sI[blk * LDI + k];
      const float c = sC[blk * LD + k];
      ids_out[gi] = k == 0 ? 0 : id;
      if constexpr (QT)
        vals_out[gi] = (k > 0 && id == ESCAPE)
                           ? qt_renorm(c, sQ[k], g.eb, g.qtf, g.rmin, g.rmax)
                           : c;
      else
        vals_out[gi] = c;
    }
  }
}

template <bool QT>
int launch(const float* x, const float* basis, const float* sf,
           const float* tol, const float* qtable, float eb, float qtf,
           long long n_pad, long long n_valid, float rmin, float rmax, float w,
           int verify, uint8_t* ids, float* vals, int* ok_tiles,
           void* stream) {
  cudaFuncSetAttribute(dct_quant_verify_kernel<QT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES<QT>));
  const long long tiles = (n_pad + TILE_N - 1) / TILE_N;
  dct_quant_verify_kernel<QT>
      <<<static_cast<unsigned>(tiles), TILE_B, SMEM_BYTES<QT>,
         static_cast<cudaStream_t>(stream)>>>(x, basis, sf, tol, qtable, eb,
                                              qtf, n_pad, n_valid, rmin, rmax,
                                              w, verify, ids, vals, ok_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dctz_dct_quant_verify(const float* x, const float* basis,
                                     const float* sf, const float* tol,
                                     long long n_pad, long long n_valid,
                                     float rmin, float rmax, float w,
                                     int verify, uint8_t* ids, float* coef,
                                     int* ok_tiles, void* stream) {
  return launch<false>(x, basis, sf, tol, nullptr, 0.f, 0.f, n_pad, n_valid,
                       rmin, rmax, w, verify, ids, coef, ok_tiles, stream);
}

extern "C" int dctz_dct_quant_verify_qt(const float* x, const float* basis,
                                        const float* sf, const float* tol,
                                        const float* qtable, float eb,
                                        float qtf, long long n_pad,
                                        long long n_valid, float rmin,
                                        float rmax, float w, int verify,
                                        uint8_t* ids, float* vals,
                                        int* ok_tiles, void* stream) {
  return launch<true>(x, basis, sf, tol, qtable, eb, qtf, n_pad, n_valid,
                      rmin, rmax, w, verify, ids, vals, ok_tiles, stream);
}
