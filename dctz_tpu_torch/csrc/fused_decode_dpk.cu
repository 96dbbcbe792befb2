// Kernel M: the one-pass DPK decode at any tile of b <= 256 blocks: unpack
// the nibbles at their stored widths, expand the exception bytes and the AC
// escapes back to their positions, dequantize (EC, or QT through the
// container's qtable), inverse DCT and unscale, with the ids and
// coefficients kept in shared memory throughout.
//
// Replaces the TPU kernel dctz_tpu/ops/research/fused_decode.py
// (fused_decode_dpk, pallas_call at line 380, body _kernel lines 152-290).
// Plain version: ops/research/fused_decode.py:_fused_decode_dpk_plain
// (idpack.unpack_ids at tile b, expand_rows of the escapes,
// quantize.decode_dense, transform.block_idct, * sf).
//
// What bounds it on the H100: about 0.4 bytes read and 4 written per
// sample, and 64 FMAs per sample (at 32Mi samples: 0.04 ms for the bytes at
// 3.35 TB/s, 0.064 ms for the FMAs at 67 TFLOP/s): operations. The design
// runs the building blocks of kernels C and D, without C's dense id and AC
// grids in device memory between them:
// - Persistent CTAs of 256 threads walk the DPK tiles of b blocks; a CTA
//   stages a tile's packed rows (64 rows of b/2 bytes, 33-word rows so that
//   the rows a half-warp reads fall on other banks) and widths, and then
//   works the tile in units of 64 blocks (dct_tile.cuh's tile; at b < 64 one
//   guarded unit of b blocks, at b = 96, 160, ... a guarded last unit).
// - Per unit, fused_decode_dpk_kernel walks the unit's 512-sample warp steps
//   (dpk_walk.cuh, C's walk): a lane unpacks 16 nibbles of 4 positions from
//   the staged rows with a funnel shift per row and step, exceptions (nibble
//   == 2^w - 1) are exact byte tests, one shuffle scan of packed counts
//   ranks them and they take the next stored byte of their chunk row; then
//   escapes (id == ESCAPE off the DC column, in real blocks) are ranked the
//   same way and take the next stored AC value. A warp walks max(cw, 512)
//   samples (cw <= 4096: 4096 / max(cw, 512) warps of the 8 share a unit);
//   at cw > 4096 one warp carries the row's counts across the units of the
//   tile. Each lane dequantizes straight into D's transposed coefficient
//   tile (center_of, or qt_inverse with denom for QT: D-QT's arithmetic).
// - Geometries the 512-sample step cannot cover (b not a multiple of 8, a
//   chunk width that is not a power of two) take the second instantiation,
//   fused_decode_dpk_lanes_kernel: one warp per chunk row, 32 samples per
//   step ranked with __ballot_sync/__popc (kernel M's first walk); a row
//   that starts before the unit is counted from its start.
// - Both run D's inverse transform on the unit (tile_product<false>, the
//   same fmaf chains in index order, times sf) and store each thread's four
//   samples of a block with one 16-byte store. So at b = 256 the output is
//   C + D's bit for bit (EC), and C + D-QT's (QT).
// - 40.75 KB of static shared memory and __launch_bounds__(256, 3) (at most
//   80 registers) let three CTAs share an SM.
//
// The card-only reference M_ref (fused_decode_dpk_ref.cu) keeps the
// per-thread inverse transform of common.cuh and the per-byte unpacking;
// chip_smoke.py and the card tests hold M bit-equal to it.

#include "dpk_walk.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;
using walk::Walk;
using walk::pack4;

constexpr int MIN_CTAS = 3;          // resident CTAs per SM that __launch_bounds__ asks
constexpr int MAX_B = 256;           // blocks per tile, at most
constexpr int RSW = MAX_B / 8 + 1;   // words per staged packed row

struct Args {
  const uint8_t* width;
  const uint8_t* packed;
  const uint8_t* exc_rows;
  const float* ac_rows;
  const float* dc;
  const float* basis;
  const float* sf;
  const float* qtable;
  long long nblk, nce, ncc;
  int b, cw, cape, capc;
  float w, rmin, rmax, denom;
  int qt;
  float* out;
};

struct __align__(16) Smem {
  float basis[BS * BS];          // B[k][m] as it comes
  float ct[TN];                  // the unit's coefficients, transposed
  float q[BS];                   // qtable (QT only)
  int wd[BS];                    // the tile's widths, 0 outside 1..4
  unsigned packed[BS * RSW];     // the tile's packed rows, b/2 bytes each
};

// The word walk and the lane walk take a call whose geometry they cover.
__host__ __device__ __forceinline__ bool word_walk(int b, int cw) {
  return b % 8 == 0 && cw >= BS && cw <= TILE_N && (cw & (cw - 1)) == 0;
}

// The coefficient of position pos of tile block kb: DC, an escape's stored
// value av (QT: inverted through the qtable), else the id's bin center; 0 in
// blocks past nblk.
__device__ __forceinline__ float coefficient(const Smem& s, const Args& a,
                                             int pos, int id, bool esc,
                                             float av, long long gblk) {
  const bool real = gblk < a.nblk;
  if (pos == 0) return real ? a.dc[gblk] : 0.f;
  if (esc) return a.qt ? qt_inverse(av, s.q[pos], a.denom, a.rmin, a.rmax) : av;
  return real ? center_of(id, a.w) : 0.f;
}

// The unit of nb blocks from tile block u0, 512-sample warp steps: warp wid
// takes steps wid*ws .. wid*ws + ws - 1 of the unit (ws = min(cw/512, 8),
// at least 1), carrying its row's counts in ecarry / acarry (reset where a
// row starts).
__device__ __forceinline__ void walk_words(Smem& s, const Args& a,
                                           const Walk& wk, long long t, int u0,
                                           int nb, int wid, int& ecarry,
                                           int& acarry) {
  const int m = wk.m;  // this lane's positions are 4m .. 4m+3
  int wd[4];
  unsigned mask[4], thrw = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wd[j] = s.wd[4 * m + j];
    mask[j] = (1u << wd[j]) - 1u;
    thrw |= (wd[j] ? mask[j] : 0xffu) << (8 * j);  // 0xff: no nibble reaches it
  }
  const int rw = a.b / 8;  // words per packed row
  const int cpt = a.b * BS / a.cw;
  const long long blk0 = t * a.b, row0 = t * cpt;
  const int ws = min(wk.steps, 8);
  const int ls1 = min((wid + 1) * ws, nb / 8);
  for (int ls = wid * ws; ls < ls1; ++ls) {
    const int st = u0 / 8 + ls;  // the step within the tile
    // the 8 values of row 4m+j at blocks 8st .. 8st+7: bits 8st*w .. 8st*w +
    // 8w of the row (the word after the row's last reads 0)
    unsigned f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bit = 8 * st * wd[j], wi = bit >> 5;
      const unsigned* pr = s.packed + (4 * m + j) * RSW;
      f[j] = __funnelshift_r(pr[wi], wi + 1 < rw ? pr[wi + 1] : 0u, bit & 31);
    }
    unsigned nw[4], eb[4];
    int ce[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kb = 2 * k + wk.half;
      unsigned w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) w |= ((f[j] >> (kb * wd[j])) & mask[j]) << (8 * j);
      nw[k] = w;
      eb[k] = walk::zero_bytes_of(w ^ thrw);  // bit 7 of byte j: an exception
      ce[k] = __popc(eb[k]);
    }
    // exceptions take the next stored byte; the DC column reads ESCAPE
    const unsigned ci = pack4(ce[0], ce[1], ce[2], ce[3]);
    const unsigned cinc = wk.scan(ci);
    int ebase[4];
    ecarry = wk.bases(st, wk.total(ci), ecarry, ebase);
    unsigned idw[4], es[4];
    int ca[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long row = row0 + wk.row(st, k);
      const uint8_t* erow = a.exc_rows + row * a.cape;
      const int lim_e = row < a.nce ? a.cape : 0;  // ranks that read a byte
      int rank = ebase[k] + walk::byte_of(cinc - ci, k);
      unsigned w = nw[k];
      for (unsigned mk = eb[k]; mk; mk &= mk - 1, ++rank) {
        const int bsh = walk::low_byte_bit(mk);
        const unsigned id = rank < lim_e ? erow[rank] : 0u;
        w = (w & ~(0xffu << bsh)) | (id << bsh);
      }
      if (m == 0) w |= 0xffu;
      idw[k] = w;
      // escapes: off the DC column, in real blocks
      unsigned e = walk::ff_bytes_of(w) & (m == 0 ? 0x80808000u : walk::HI);
      if (blk0 + wk.block(st, k) >= a.nblk) e = 0;
      es[k] = e;
      ca[k] = __popc(e);
    }
    // escapes take the next stored AC value; every coefficient goes into
    // the transposed tile
    const unsigned ai = pack4(ca[0], ca[1], ca[2], ca[3]);
    const unsigned ainc = wk.scan(ai);
    int abase[4];
    acarry = wk.bases(st, wk.total(ai), acarry, abase);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kb = wk.block(st, k), bl = kb - u0;
      const long long row = row0 + wk.row(st, k);
      const float* arow = a.ac_rows + row * a.capc;
      const int lim_a = row < a.ncc ? a.capc : 0;
      int rank = abase[k] + walk::byte_of(ainc - ai, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = 4 * m + j;
        const bool esc = (es[k] >> (8 * j + 7)) & 1u;
        float av = 0.f;
        if (esc) {
          av = rank < lim_a ? arow[rank] : 0.f;
          ++rank;
        }
        s.ct[pos * BS + tcol(pos, bl)] = coefficient(
            s, a, pos, walk::byte_of(idw[k], j), esc, av, blk0 + kb);
      }
    }
  }
}

// The unit of nb blocks from tile block u0, one warp per chunk row that
// meets it, 32 samples per step; a row that starts before the unit is
// counted from its start, and only the unit's samples are written.
__device__ __forceinline__ void walk_lanes(Smem& s, const Args& a, long long t,
                                           int u0, int nb, int wid, int lane) {
  const int e_lo = u0 * BS, e_hi = (u0 + nb) * BS;
  const int cpt = a.b * BS / a.cw, half = a.b / 2;
  const long long blk0 = t * a.b;
  const unsigned below = lanes_below();
  const uint8_t* sP = reinterpret_cast<const uint8_t*>(s.packed);
  for (int r = e_lo / a.cw + wid; r <= (e_hi - 1) / a.cw; r += tile::WARPS) {
    const long long row = t * cpt + r;
    const bool have_e = row < a.nce, have_c = row < a.ncc;
    const int end = min((r + 1) * a.cw, e_hi);
    int ecount = 0, acount = 0;
    for (int e0 = r * a.cw; e0 < end; e0 += 32) {
      const int e = e0 + lane;
      const int kb = e >> 6, pos = e & 63;
      const long long gblk = blk0 + kb;
      const int wd = s.wd[pos];
      int nib = 0;
      if (wd > 0) {  // a width-3 field may straddle into the next byte
        const uint8_t* prow = sP + pos * RSW * 4;
        const int bit = kb * wd, by = bit >> 3;
        const int lo = prow[by];
        const int hi = wd == 3 ? prow[min(by + 1, half - 1)] : 0;
        nib = ((lo | (hi << 8)) >> (bit & 7)) & ((1 << wd) - 1);
      }
      const bool mexc = wd > 0 && nib == (1 << wd) - 1;
      const unsigned bm = __ballot_sync(FULL, mexc);
      const int rank = ecount + __popc(bm & below);
      int id = nib;
      if (mexc) id = (have_e && rank < a.cape) ? a.exc_rows[row * a.cape + rank] : 0;
      if (pos == 0) id = ESCAPE;
      const bool esc = pos >= 1 && id == ESCAPE && gblk < a.nblk;
      const unsigned ba = __ballot_sync(FULL, esc);
      const int arank = acount + __popc(ba & below);
      if (e >= e_lo) {
        const float av = (esc && have_c && arank < a.capc) ? a.ac_rows[row * a.capc + arank] : 0.f;
        s.ct[pos * BS + tcol(pos, kb - u0)] = coefficient(s, a, pos, id, esc, av, gblk);
      }
      ecount += __popc(bm);
      acount += __popc(ba);
    }
  }
}

template <bool WORDS>
__device__ __forceinline__ void decode(Smem& s, const Args& a) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int hi = tid >> 4, lo = tid & 15;
  const long long tiles = (a.nblk + a.b - 1) / a.b;
  const float sf = *a.sf;
  const Walk wk(WORDS ? a.cw : BS);

  for (int i = 4 * tid; i < BS * BS; i += 4 * THREADS)
    st4(s.basis + i, ld4(a.basis + i));
  if (tid < BS) s.q[tid] = a.qt ? a.qtable[tid] : 0.f;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();  // the last tile's readers of the staged rows are done
    if (tid < BS) {
      const int w = a.width[t * BS + tid];
      s.wd[tid] = w <= 4 ? w : 0;
    }
    if constexpr (WORDS) {  // b / 8 words per row
      const int rw = a.b / 8;
      const unsigned* src = reinterpret_cast<const unsigned*>(a.packed) + t * BS * rw;
      for (int i = tid; i < BS * rw; i += THREADS) {
        const int p = i / rw;
        s.packed[p * RSW + (i - p * rw)] = src[i];
      }
    } else {  // b / 2 bytes per row
      const int half = a.b / 2;
      const uint8_t* src = a.packed + t * BS * half;
      uint8_t* dst = reinterpret_cast<uint8_t*>(s.packed);
      for (int i = tid; i < BS * half; i += THREADS) {
        const int p = i / half;
        dst[p * RSW * 4 + (i - p * half)] = src[i];
      }
    }
    __syncthreads();

    const long long blk0 = t * a.b;
    int ecarry = 0, acarry = 0;
    for (int u0 = 0; u0 < a.b && blk0 + u0 < a.nblk; u0 += TB) {
      const int nb = min(TB, a.b - u0);
      if constexpr (WORDS)
        walk_words(s, a, wk, t, u0, nb, wid, ecarry, acarry);
      else
        walk_lanes(s, a, t, u0, nb, wid, lane);
      __syncthreads();  // the unit's coefficients are staged

      float acc[4][4];
      tile_product<false>(s.ct, s.basis, hi, lo, acc);
#pragma unroll
      for (int bi = 0; bi < 4; ++bi) {
        const int bl = 4 * hi + bi;
        const long long gblk = blk0 + u0 + bl;
        if (bl < nb && gblk < a.nblk)
          st4(a.out + gblk * BS + 4 * lo,
              make_float4(acc[bi][0] * sf, acc[bi][1] * sf, acc[bi][2] * sf,
                          acc[bi][3] * sf));
      }
      __syncthreads();  // the tile is read; the next unit may stage
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    fused_decode_dpk_kernel(const Args a) {
  __shared__ Smem s;
  decode<true>(s, a);
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    fused_decode_dpk_lanes_kernel(const Args a) {
  __shared__ Smem s;
  decode<false>(s, a);
}

}  // namespace

extern "C" int dctz_fused_decode_dpk(const uint8_t* width, const uint8_t* packed,
                                     const uint8_t* exc_rows,
                                     const float* ac_rows, const float* dc,
                                     const float* basis, const float* sf,
                                     const float* qtable, long long nblk,
                                     long long nce, long long ncc, int b,
                                     int cw, int cape, int capc, float w,
                                     float rmin, float rmax, float denom,
                                     int qt, float* out, void* stream) {
  if (b < 2 || b > MAX_B || b % 2 != 0 || cw < BS || cw % BS != 0 ||
      (b * BS) % cw != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int cache_words[MAX_DEVICES] = {};
  static int cache_lanes[MAX_DEVICES] = {};
  const long long tiles = (nblk + b - 1) / b;
  if (tiles == 0) return 0;
  const Args a{width, packed, exc_rows, ac_rows, dc,   basis, sf,    qtable,
               nblk,  nce,    ncc,      b,       cw,   cape,  capc,  w,
               rmin,  rmax,   denom,    qt,      out};
  const bool words = word_walk(b, cw);
  const long long grid =
      words ? persistent_grid(fused_decode_dpk_kernel, 0, tiles, cache_words)
            : persistent_grid(fused_decode_dpk_lanes_kernel, 0, tiles, cache_lanes);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = words ? fused_decode_dpk_kernel : fused_decode_dpk_lanes_kernel;
  kernel<<<static_cast<unsigned>(grid), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Which instantiation a call takes: 1 the word walk, 0 the lane walk.
extern "C" int dctz_fused_decode_dpk_word_walk(int b, int cw) {
  return word_walk(b, cw) ? 1 : 0;
}

// Resident CTAs per SM: the lesser of the two instantiations.
extern "C" int dctz_ctas_per_sm_fused_decode_dpk() {
  const int words = tile_ctas_per_sm(fused_decode_dpk_kernel, 0);
  const int lanes = tile_ctas_per_sm(fused_decode_dpk_lanes_kernel, 0);
  return words < lanes ? words : lanes;
}
