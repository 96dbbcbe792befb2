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
// What bounds it on the H100: 128 MB read and 160 MB written for 32Mi
// samples, 0.090 ms at 3.35 TB/s; the forward DCT's 64 fmaf per sample,
// 0.064 ms at 67 TFLOP/s; the reconstructions of the blocks the L2 screen
// flags come on top. The two are close, so the design keeps the FMA units fed
// while the next tile's samples are in flight:
// - A CTA of 256 threads takes a tile of 64 DCT blocks (dct_tile.cuh): a
//   register-tiled product with 16 independent chains per thread, two 16-byte
//   shared loads per 16 fmaf, in place of one 64-long chain per thread with a
//   shared load per fmaf. 55 KB of shared memory and __launch_bounds__(256, 4)
//   (at most 64 registers) let four CTAs share an SM.
// - The CTAs are persistent (a grid of CTAs-per-SM x SMs walks the tiles) and
//   load the next tile with cp.async into a raw buffer while they transform
//   this one. cp.async rather than a prefetch into registers: the 16 floats a
//   thread would hold across the product and the repair cost registers that
//   the 64-register budget does not have, and the raw buffer is free as soon
//   as the staging pass has divided it into the transposed tile, so one
//   buffer suffices.
// - The epilogue bins each thread's 16 coefficients of the tile. The L2
//   screen sums d*d per block in k order on one thread per block, the
//   same sum as before (hat and d are recomputed there from the coefficient
//   and its id rather than stored: a d tile would cost 16 KB and a CTA per
//   SM), so the screen flags exactly the blocks it flagged. The exact check
//   and the two repair passes run one warp per flagged block: lanes own
//   positions m = lane, lane + 32 of the reconstruction and coefficients k =
//   lane, lane + 32 of hat and the repair; the block's max error is a
//   __shfl_xor max. The samples of the error are read again from device
//   memory (the raw buffer already holds the next tile; the L2 still has it).
//
// Bit-exactness: every coefficient is fmaf(xs[m], B[k][m], c) from 0.f over
// m = 0..63 in order with xs[m] = x[m] / sf an IEEE division, and every
// reconstructed sample the k-order chain times sf, as common.cuh's
// forward_dct / inverse_dct (kernels L_ref and M_ref) compute them. No TF32 and
// no --use_fast_math; (v - rmin) / w and the QT renormalization are IEEE.
//
// The L2 screen gates the exact check per DCT block (the TPU kernel gates per
// tile); the screen is a rigorous bound, so which blocks are repaired does
// not depend on the gating granularity. ok_tiles gets one flag per 64-block
// tile. counters, when not null, accumulates (blocks the screen flagged,
// blocks whose exact check failed and were repaired).
//
// template <bool RELAXED>: the TPU kernel's relaxed arm (dct_precision
// "high", dpk_fuse.py:510-516 and :603-607). The coefficients come from
// dct_tile.cuh:tile_product_bf16x3, three bfloat16 products on the tensor
// cores, and the L2 screen's rounding budget widens from 32 to 1024 eps *
// max|xs|; the exact check and the repair passes keep the fp32
// reconstruction above, so the guarantee is that of the HIGHEST arm. Its
// bf16 basis tiles take 16 KB more shared memory (71 KB), so the
// instantiation asks for 3 resident CTAs per SM rather than 4.

#include "dct_tile.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;

constexpr int MIN_CTAS = 4;  // resident CTAs per SM that __launch_bounds__ asks
constexpr int MIN_CTAS_RELAXED = 3;  // the same, of the RELAXED instantiations
constexpr int LDI = 68;      // padded byte row of the id tile
// shared memory: transposed basis, raw samples, the transposed sample tile
// (then the coefficient tile), per-warp hat rows, qtable, per-block max|xs|,
// the flagged-block list, ids; RELAXED: the raw buffer holds the bf16 sample
// tiles until the product is done, and the bf16 basis tiles follow
constexpr size_t SMEM_BYTES = sizeof(float) * (3 * TN + WARPS * BS + BS + TB) +
                              sizeof(int) * TB + TB * LDI;
constexpr size_t SMEM_BYTES_RELAXED = SMEM_BYTES + 2 * sizeof(__nv_bfloat16) * HT;

template <bool RELAXED>
constexpr size_t smem_bytes() { return RELAXED ? SMEM_BYTES_RELAXED : SMEM_BYTES; }

// The decoder's coefficient at position k of a block: DC reads the
// coefficient, an AC escape its stored value (EC: the coefficient; QT: the
// renormalized value, inverted as the decoder inverts it), everything else
// its bin center.
template <bool QT>
__device__ __forceinline__ float hat_of(int k, float c, int id, bool acm,
                                        float q, const Geom& g) {
  if (k == 0) return c;
  if (!(acm && id == ESCAPE)) return center_of(id, g.w);
  if constexpr (QT)
    return qt_inverse(qt_renorm(c, q, g.eb, g.qtf, g.rmin, g.rmax), q, g.denom,
                      g.rmin, g.rmax);
  return c;
}

// Max pointwise error of block b's reconstruction from its current ids, on
// one warp: lane holds coefficients k0 = lane, k1 = lane + 32 (c0, c1, ids
// id0, id1) and leaves their hat in hat0, hat1; it reconstructs positions
// m = lane, lane + 32 as k-order chains times sf.
template <bool QT>
__device__ __forceinline__ float block_error(
    const float* __restrict__ sBT, float* __restrict__ h,
    const float* __restrict__ x, long long gblk, long long n_pad,
    long long n_valid, const Geom& g, int lane, float c0, float c1, int id0,
    int id1, float q0, float q1, float& hat0, float& hat1) {
  const int k0 = lane, k1 = lane + 32;
  hat0 = hat_of<QT>(k0, c0, id0, k0 > 0 && gblk + k0 < n_pad, q0, g);
  hat1 = hat_of<QT>(k1, c1, id1, gblk + k1 < n_pad, q1, g);
  __syncwarp();
  h[k0] = hat0;
  h[k1] = hat1;
  __syncwarp();
  const int m0 = lane, m1 = lane + 32;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
  for (int j = 0; j < BS / 4; ++j) {
    const float4 hv = ld4(h + 4 * j);
    const float4 b0 = ld4(sBT + m0 * BS + rcol(m0, 4 * j));
    const float4 b1 = ld4(sBT + m1 * BS + rcol(m1, 4 * j));
    s0 = fmaf(hv.x, b0.x, s0);
    s0 = fmaf(hv.y, b0.y, s0);
    s0 = fmaf(hv.z, b0.z, s0);
    s0 = fmaf(hv.w, b0.w, s0);
    s1 = fmaf(hv.x, b1.x, s1);
    s1 = fmaf(hv.y, b1.y, s1);
    s1 = fmaf(hv.z, b1.z, s1);
    s1 = fmaf(hv.w, b1.w, s1);
  }
  float e = 0.f;
  const float xh0 = s0 * g.sf;
  if (gblk + m0 < n_valid) e = fmaxf(e, fabsf(xh0 - x[gblk + m0]));
  const float xh1 = s1 * g.sf;
  if (gblk + m1 < n_valid) e = fmaxf(e, fabsf(xh1 - x[gblk + m1]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    e = fmaxf(e, __shfl_xor_sync(FULL, e, off));
  return e;
}

template <bool QT, bool RELAXED>
__global__ void __launch_bounds__(THREADS, RELAXED ? MIN_CTAS_RELAXED : MIN_CTAS)
    dct_quant_verify_kernel(const float* __restrict__ x,
                            const float* __restrict__ basis,
                            const float* __restrict__ sf_p,
                            const float* __restrict__ tol_p,
                            const float* __restrict__ qtable, float eb,
                            float qtf, long long n_pad, long long n_valid,
                            float rmin, float rmax, float w, int verify,
                            uint8_t* __restrict__ ids_out,
                            float* __restrict__ vals_out,
                            int* __restrict__ ok_tiles,
                            unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  float* sBT = smem;          // basis, row m holds B[k][m] at rcol(m, k)
  float* sRaw = sBT + TN;     // samples as loaded, block-major
  float* sT = sRaw + TN;      // xs transposed; then coefficients, row b
  float* sH = sT + TN;        // per-warp hat rows of the exact check
  float* sQ = sH + WARPS * BS;                                  // qtable
  float* sMx = sQ + BS;                                         // max|xs|
  int* sList = reinterpret_cast<int*>(sMx + TB);                // flagged
  uint8_t* sI = reinterpret_cast<uint8_t*>(sList + TB);         // ids
  __nv_bfloat16* sBh = reinterpret_cast<__nv_bfloat16*>(sI + TB * LDI);  // RELAXED
  __shared__ int sCount, sRepaired, sOk;
  // tol / sf of the L2 screen, kept here rather than in a register across
  // the tile loop (ptxas spilled it there)
  __shared__ float sTolSf;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hi = tid >> 4, lo = tid & 15;
  const long long tiles = (n_pad + TN - 1) / TN;
  const Geom g{rmin, rmax, w, *sf_p, *tol_p, eb, qtf, __fmul_rn(eb, qtf)};

  long long t = blockIdx.x;
  load_tile_async(sRaw, x, t, n_pad, tid);
  load_basis_transposed(sBT, basis, tid);
  if constexpr (RELAXED) load_basis_split(sBh, sBh + HT, basis, tid);
  if constexpr (QT) {
    if (tid < BS) sQ[tid] = qtable[tid];
  }
  if (tid == 0) sTolSf = g.tol / g.sf;

  for (; t < tiles; t += gridDim.x) {
    const long long base = t * TN;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's readers are done

    // xs = x / sf into the transposed tile, and each block's max |xs|
    stage_scaled<true, RELAXED>(sRaw, sT, g.sf, hi, lo, sMx);
    if (tid == 0) {
      sCount = 0;
      sRepaired = 0;
      sOk = 1;
    }
    __syncthreads();  // the tile is staged; sRaw is free (RELAXED: after the product)
    if (!RELAXED && t + gridDim.x < tiles)
      load_tile_async(sRaw, x, t + gridDim.x, n_pad, tid);

    // the forward DCT of the tile into the coefficient tile, then the bins of
    // the thread's own coefficients, one float4 at a time; DC escapes
    if constexpr (RELAXED) {
      const __nv_bfloat16* sXh = reinterpret_cast<const __nv_bfloat16*>(sRaw);
      tile_product_bf16x3(sXh, sXh + HT, sBh, sBh + HT, sT, tid);
      if (t + gridDim.x < tiles) load_tile_async(sRaw, x, t + gridDim.x, n_pad, tid);
    } else {
      float acc[4][4];
      tile_product<true>(sT, sBT, hi, lo, acc);
      __syncthreads();  // sT is read; it takes the coefficients
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        const int b = 4 * hi + bi;
        st4(sT + b * BS + rcol(b, 4 * lo),
            make_float4(acc[bi][0], acc[bi][1], acc[bi][2], acc[bi][3]));
      }
    }
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
      const int b = 4 * hi + bi;
      const float4 c4 = ld4(sT + b * BS + rcol(b, 4 * lo));
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      unsigned word = 0;
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) {
        const int k = 4 * lo + ki;
        const int id = k == 0 ? ESCAPE : ac_bin<QT>(cv[ki], QT ? sQ[k] : 0.f, g);
        word |= static_cast<unsigned>(id) << (8 * ki);
      }
      *reinterpret_cast<unsigned*>(sI + b * LDI + 4 * lo) = word;
    }
    __syncthreads();

    if (verify) {
      // L2 screen, one thread per block: |IDCT(delta)_i| <= ||delta||_2 for
      // the orthonormal basis, minus a transform-rounding budget of
      // 32 eps * max|xs| (RELAXED: 1024, the bf16x3 analysis rounding enters
      // the stored escapes); d*d summed in k order
      if (tid < TB) {
        const int b = tid;
        const long long gblk = base + static_cast<long long>(b) * BS;
        if (gblk < n_pad) {
          float l2 = 0.f;
#pragma unroll 4
          for (int j = 0; j < BS / 4; ++j) {
            const float4 c4 = ld4(sT + b * BS + rcol(b, 4 * j));
            const unsigned word =
                *reinterpret_cast<const unsigned*>(sI + b * LDI + 4 * j);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 4 * j + i;
              const float c = cv[i];
              const int id = (word >> (8 * i)) & 0xff;
              const bool acm = k > 0 && gblk + k < n_pad;
              const float hat = hat_of<QT>(k, c, id, acm, QT ? sQ[k] : 0.f, g);
              const float d = hat - c;
              l2 += d * d;
            }
          }
          const float eps32 = 1.1920929e-07f;
          const float thr = sTolSf - (RELAXED ? 1024.0f : 32.0f) * eps32 * sMx[b];
          if (l2 > thr * thr || thr <= 0.f) sList[atomicAdd(&sCount, 1)] = b;
        }
      }
      __syncthreads();

      // the exact check and the two repair passes, one warp per flagged block
      const int nflag = sCount;
      for (int f = warp; f < nflag; f += WARPS) {
        const int b = sList[f];
        const long long gblk = base + static_cast<long long>(b) * BS;
        const int k0 = lane, k1 = lane + 32;
        const float c0 = sT[b * BS + rcol(b, k0)], c1 = sT[b * BS + rcol(b, k1)];
        int id0 = sI[b * LDI + k0], id1 = sI[b * LDI + k1];
        const float q0 = QT ? sQ[k0] : 0.f, q1 = QT ? sQ[k1] : 0.f;
        float* h = sH + warp * BS;
        float hat0, hat1;
        float blk = block_error<QT>(sBT, h, x, gblk, n_pad, n_valid, g, lane,
                                    c0, c1, id0, id1, q0, q1, hat0, hat1);
        if (blk > g.tol) {
          if (lane == 0) atomicAdd(&sRepaired, 1);
          // two passes with falling floors, w/8 then w*1e-3
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            // pass 0 sees the ids the error above was taken from
            if (pass > 0)
              blk = block_error<QT>(sBT, h, x, gblk, n_pad, n_valid, g, lane,
                                    c0, c1, id0, id1, q0, q1, hat0, hat1);
            if (blk > g.tol) {
              const float fl = pass == 0 ? g.w / 8.0f : g.w * 1e-3f;
              // QT: an escape carries ~1.5e-6 * qtable[k] of error itself
              const float f0 = QT ? fmaxf(fl, __fmul_rn(3e-6f, fabsf(q0))) : fl;
              const float f1 = QT ? fmaxf(fl, __fmul_rn(3e-6f, fabsf(q1))) : fl;
              if (k0 > 0 && gblk + k0 < n_pad && fabsf(c0 - hat0) > f0) id0 = ESCAPE;
              if (gblk + k1 < n_pad && fabsf(c1 - hat1) > f1) id1 = ESCAPE;
            }
          }
          blk = block_error<QT>(sBT, h, x, gblk, n_pad, n_valid, g, lane, c0,
                                c1, id0, id1, q0, q1, hat0, hat1);
          if (lane == 0 && blk > g.tol) sOk = 0;
          sI[b * LDI + k0] = static_cast<uint8_t>(id0);
          sI[b * LDI + k1] = static_cast<uint8_t>(id1);
        }
      }
      __syncthreads();
    }

    // streams, 16-byte stores of the coefficient rows: ids zeroed at DC; the
    // coefficients, except QT's AC escapes, which store their renormalized
    // values; blocks past n_pad are not written
#pragma unroll
    for (int bi = 0; bi < 4; ++bi) {
      const int b = 4 * hi + bi;
      const long long gi = base + static_cast<long long>(b) * BS + 4 * lo;
      if (gi < n_pad) {
        unsigned word = *reinterpret_cast<const unsigned*>(sI + b * LDI + 4 * lo);
        if (lo == 0) word &= ~0xffu;
        float4 c = ld4(sT + b * BS + rcol(b, 4 * lo));
        if constexpr (QT) {
          float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int ki = 0; ki < 4; ++ki) {
            const int k = 4 * lo + ki;
            if (k > 0 && ((word >> (8 * ki)) & 0xff) == ESCAPE)
              cv[ki] = qt_renorm(cv[ki], sQ[k], g.eb, g.qtf, g.rmin, g.rmax);
          }
          c = make_float4(cv[0], cv[1], cv[2], cv[3]);
        }
        *reinterpret_cast<unsigned*>(ids_out + gi) = word;
        st4(vals_out + gi, c);
      }
    }
    if (tid == 0) {
      ok_tiles[t] = sOk;
      if (counters != nullptr) {
        atomicAdd(counters, static_cast<unsigned long long>(sCount));
        atomicAdd(counters + 1, static_cast<unsigned long long>(sRepaired));
      }
    }
  }
}

template <bool QT, bool RELAXED>
int launch(const float* x, const float* basis, const float* sf,
           const float* tol, const float* qtable, float eb, float qtf,
           long long n_pad, long long n_valid, float rmin, float rmax, float w,
           int verify, uint8_t* ids, float* vals, int* ok_tiles,
           unsigned long long* counters, void* stream) {
  static int cache[MAX_DEVICES] = {};
  const long long tiles = (n_pad + TN - 1) / TN;
  if (tiles == 0) return 0;
  constexpr size_t smem = smem_bytes<RELAXED>();
  const long long grid =
      persistent_grid(dct_quant_verify_kernel<QT, RELAXED>, smem, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  dct_quant_verify_kernel<QT, RELAXED>
      <<<static_cast<unsigned>(grid), THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(x, basis, sf, tol, qtable, eb,
                                              qtf, n_pad, n_valid, rmin, rmax,
                                              w, verify, ids, vals, ok_tiles,
                                              counters);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
template <bool QT, bool RELAXED>
int occupancy() {
  return tile_ctas_per_sm(dct_quant_verify_kernel<QT, RELAXED>, smem_bytes<RELAXED>());
}

}  // namespace

// The C entry points: A and A-QT, each in its HIGHEST and RELAXED
// instantiation.
#define DCTZ_A_ENTRY(NAME, RELAXED)                                            \
  extern "C" int NAME(const float* x, const float* basis, const float* sf,   \
                      const float* tol, long long n_pad, long long n_valid,   \
                      float rmin, float rmax, float w, int verify,            \
                      uint8_t* ids, float* coef, int* ok_tiles,              \
                      unsigned long long* counters, void* stream) {          \
    return launch<false, RELAXED>(x, basis, sf, tol, nullptr, 0.f, 0.f,      \
                                  n_pad, n_valid, rmin, rmax, w, verify, ids, \
                                  coef, ok_tiles, counters, stream);          \
  }
#define DCTZ_A_QT_ENTRY(NAME, RELAXED)                                         \
  extern "C" int NAME(const float* x, const float* basis, const float* sf,   \
                      const float* tol, const float* qtable, float eb,       \
                      float qtf, long long n_pad, long long n_valid,         \
                      float rmin, float rmax, float w, int verify,           \
                      uint8_t* ids, float* vals, int* ok_tiles,              \
                      unsigned long long* counters, void* stream) {          \
    return launch<true, RELAXED>(x, basis, sf, tol, qtable, eb, qtf, n_pad,  \
                                 n_valid, rmin, rmax, w, verify, ids, vals,  \
                                 ok_tiles, counters, stream);                \
  }

DCTZ_A_ENTRY(dctz_dct_quant_verify, false)
DCTZ_A_ENTRY(dctz_dct_quant_verify_relaxed, true)
DCTZ_A_QT_ENTRY(dctz_dct_quant_verify_qt, false)
DCTZ_A_QT_ENTRY(dctz_dct_quant_verify_qt_relaxed, true)

extern "C" int dctz_ctas_per_sm_dct_quant_verify() { return occupancy<false, false>(); }
extern "C" int dctz_ctas_per_sm_dct_quant_verify_qt() { return occupancy<true, false>(); }
extern "C" int dctz_ctas_per_sm_dct_quant_verify_relaxed() {
  return occupancy<false, true>();
}
extern "C" int dctz_ctas_per_sm_dct_quant_verify_qt_relaxed() {
  return occupancy<true, true>();
}
