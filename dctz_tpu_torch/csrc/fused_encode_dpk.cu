// Kernel L: the one-pass DPK encode, raw samples to coded DPK streams (EC,
// no verify): scale, forward DCT, bin ids, then widths, bit packing and the
// chunk-row compaction of exception bytes and AC escapes, with the tile's
// ids and coefficients kept in shared memory between the two halves.
//
// Replaces the TPU kernel dctz_tpu/ops/research/fused_encode_dpk.py
// (fused_encode_dpk, pallas_call at line 360, body _kernel lines 195-315).
// Plain version: ops/research/fused_encode_dpk.py:_fused_encode_dpk_plain
// (kernel F's plain version, then idpack.pack_ids at cape 128, then
// compact_rows of the AC escapes at capc 128).
//
// What bounds it on the H100: 4 bytes read per sample against about 0.4
// written, and 64 FMAs per sample (at 32Mi samples: 0.04 ms for the bytes at
// 3.35 TB/s, 0.064 ms for the FMAs at 67 TFLOP/s): operations. The design
// runs the building blocks of kernels F and B:
// - Persistent CTAs of 256 threads walk the DPK tiles (256 DCT blocks,
//   16384 samples). Each tile is four sub-tiles of 64 blocks, each through
//   F's front end (dct_tile.cuh): cp.async of the next sub-tile's samples
//   while this one is transformed (load_tile_async), the basis transposed
//   once per CTA, xs = x / sf staged transposed (stage_scaled), the
//   register-tiled product (tile_product<true>), and F's bins on the
//   accumulators (ac_bin). So the ids and coefficients are F's bit for bit.
// - Per sub-tile, each thread writes its 16 ids into the DPK tile's id
//   buffer (block rows, B's layout), its coefficients into a row tile over
//   the transposed staging tile (the product has read it), and each block's
//   DC to device memory. Then the 8 warps walk the sub-tile's 8 chunk rows
//   of 512 samples, one warp step each (dpk_walk.cuh): escapes are exact
//   byte tests in the id words, one shuffle scan ranks them, a lane reads
//   the values of its escapes from the coefficient tile with one 16-byte
//   load per word that has any, and stores the first 128 of the row, the
//   zero tail and the true escape count. The rule is compact_chunked's,
//   behind F: rank among the chunk row's escapes alone.
// - After a tile's fourth sub-tile, B's word-wide stages run on the id
//   buffer (dpk_stages.cuh, the same functions B calls): nibble copy and
//   threshold counts, widths, packing, and the walk of the exception bytes
//   (walk_exceptions<false>: no escapes are kept there).
// - 74.3 KB of shared memory and __launch_bounds__(256, 3) (at most 80
//   registers) let three CTAs share an SM.
// Zero padding of the tail tile bins like data and is masked to id 0 as it
// is read (stages::id_word), as B masks it.
//
// The card-only reference L_ref (fused_encode_dpk_ref.cu) keeps the
// per-thread transform of common.cuh and the per-byte stages of
// dpk_tile.cuh; chip_smoke.py and the card tests hold L equal to it on all
// seven streams.

#include "dpk_stages.cuh"

namespace {

using namespace dctz;
using namespace dctz::tile;
using walk::Walk;
using walk::pack4;

constexpr int MIN_CTAS = 3;          // resident CTAs per SM that __launch_bounds__ asks
constexpr int CW = 512;              // chunk width (n % 1024 == 0 always gives 512)
constexpr int CAP = 128;             // exception and AC slots per chunk row
constexpr int NC = TILE_N / CW;      // chunk rows per DPK tile
constexpr int SUBS = TILE_B / TB;    // 64-block sub-tiles per DPK tile

struct __align__(16) Smem {
  float bt[TN];          // basis, row m holds B[k][m] at rcol(m, k)
  float raw[TN];         // the sub-tile's samples as loaded
  float t[TN];           // xs transposed; then the coefficients, row tile
  uint8_t ids[TILE_N];   // the DPK tile's ids, block rows
  stages::Smem st;       // nibble copy, counts, widths
};
constexpr size_t SMEM_BYTES = sizeof(Smem);

// The epilogue of sub-tile j: the bins of the thread's 4 x 4 coefficients
// (blocks 4*hi + bi, positions 4*lo .. 4*lo+3) as one id word per block into
// the DPK tile's id rows (0 at DC), the coefficients into the row tile, and
// each block's DC into dc_tile.
__device__ __forceinline__ void store_subtile(const float (&acc)[4][4], int j,
                                              int hi, int lo, const Geom& g,
                                              Smem& s,
                                              float* __restrict__ dc_tile) {
#pragma unroll
  for (int bi = 0; bi < 4; ++bi) {
    const int b = 4 * hi + bi;
    unsigned word = 0;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const int k = 4 * lo + ci;
      const int id = k == 0 ? 0 : ac_bin<false>(acc[bi][ci], 0.f, g);
      word |= static_cast<unsigned>(id) << (8 * ci);
    }
    *reinterpret_cast<unsigned*>(s.ids + (TB * j + b) * BS + 4 * lo) = word;
    st4(s.t + b * BS + rcol(b, 4 * lo),
        make_float4(acc[bi][0], acc[bi][1], acc[bi][2], acc[bi][3]));
    if (lo == 0) dc_tile[TB * j + b] = acc[bi][0];
  }
}

// Chunk row 8j + wid of the DPK tile, one warp step of 512 samples: the
// escapes (id == ESCAPE off the DC column) in sample order, the first CAP
// of them into the row, its zero tail, and the true count.
__device__ __forceinline__ void walk_escapes(const Smem& s, const Walk& wk,
                                             int j, int wid, bool full,
                                             int valid, float* __restrict__ ac_t,
                                             int* __restrict__ ac_cnt_t) {
  const int st = TB / 8 * j + wid;  // the step, and the row (cw = 512)
  const unsigned dcm = stages::dc_mask(wk.m);
  unsigned e[4];
  int ca[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = walk::ff_bytes_of(
        stages::id_word(s.ids, wk.block(st, k), wk.m, dcm, full, valid));
    ca[k] = __popc(e[k]);
  }
  const unsigned ai = pack4(ca[0], ca[1], ca[2], ca[3]);
  const unsigned ainc = wk.scan(ai);
  const unsigned atot = wk.total(ai);
  float4 kv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int bl = wk.block(st, k) - TB * j;
    kv[k] = e[k] ? ld4(s.t + bl * BS + rcol(bl, 4 * wk.m))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* arow = ac_t + st * CAP;
  int run = 0;  // escapes of the row before sub-step k
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int rank = run + walk::byte_of(ainc - ai, k);
    for (unsigned mk = e[k]; mk && rank < CAP; mk &= mk - 1, ++rank) {
      const int q = walk::low_byte_bit(mk) >> 3;
      arow[rank] = q == 0 ? kv[k].x : q == 1 ? kv[k].y : q == 2 ? kv[k].z : kv[k].w;
    }
    run += walk::byte_of(atot, k);
  }
  stages::zero_floats(arow, min(run, CAP), CAP, wk, true);
  if (wk.gl == 0) ac_cnt_t[st] = run;
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    fused_encode_dpk_kernel(const float* __restrict__ x,
                            const float* __restrict__ basis,
                            const float* __restrict__ sf_p, long long n,
                            float rmin, float rmax, float w,
                            uint8_t* __restrict__ width_out,
                            uint8_t* __restrict__ packed_out,
                            uint8_t* __restrict__ exc_out,
                            float* __restrict__ ac_out,
                            int* __restrict__ exc_cnt,
                            int* __restrict__ ac_cnt,
                            float* __restrict__ dc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int tid = threadIdx.x, wid = tid >> 5, hi = tid >> 4, lo = tid & 15;
  const long long tiles = (n + TILE_N - 1) / TILE_N;
  const Geom g{rmin, rmax, w, *sf_p, 0.f, 0.f, 0.f, 0.f};
  const Walk wk(CW);

  load_tile_async(s.raw, x, static_cast<long long>(blockIdx.x) * SUBS, n, tid);
  load_basis_transposed(s.bt, basis, tid);

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int valid = static_cast<int>(min(n - t * TILE_N, static_cast<long long>(TILE_N)));
    const bool full = valid == TILE_N;
    for (int j = 0; j < SUBS; ++j) {
      cp_async_wait_all();
      __syncthreads();  // sub-tile landed; the last sub-tile's readers are done
      stage_scaled<false>(s.raw, s.t, g.sf, hi, lo, nullptr);
      __syncthreads();  // the sub-tile is staged; raw is free
      const long long next = j + 1 < SUBS ? t * SUBS + j + 1 : (t + gridDim.x) * SUBS;
      if (next < tiles * SUBS) load_tile_async(s.raw, x, next, n, tid);

      float acc[4][4];
      tile_product<true>(s.t, s.bt, hi, lo, acc);
      __syncthreads();  // s.t is read; it takes the coefficient rows
      store_subtile(acc, j, hi, lo, g, s, dc_out + t * TILE_B);
      __syncthreads();
      walk_escapes(s, wk, j, wid, full, valid, ac_out + t * NC * CAP, ac_cnt + t * NC);
    }

    // B's word-wide stages on the tile's ids
    stages::nibbles_and_counts(s.ids, s.st, tid, full, valid);
    __syncthreads();
    stages::select_widths(s.st, tid, width_out + t * BS);
    __syncthreads();
    stages::pack_tile(s.st, tid, packed_out + t * BS * 128);
    stages::walk_exceptions<false>(s.ids, s.st, wk, wid, full, valid, CAP,
                                   exc_out + t * NC * CAP, exc_cnt + t * NC,
                                   nullptr, nullptr, nullptr);
  }
}

}  // namespace

// x: n (a multiple of 1024) floats on 16 bytes.
extern "C" int dctz_fused_encode_dpk(const float* x, const float* basis,
                                     const float* sf, long long n, float rmin,
                                     float rmax, float w, uint8_t* width,
                                     uint8_t* packed, uint8_t* exc, float* ac,
                                     int* exc_counts, int* ac_counts,
                                     float* dc, void* stream) {
  static int cache[MAX_DEVICES] = {};
  const long long tiles = (n + TILE_N - 1) / TILE_N;
  if (tiles == 0) return 0;
  const long long grid =
      persistent_grid(fused_encode_dpk_kernel, SMEM_BYTES, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_encode_dpk_kernel<<<static_cast<unsigned>(grid), THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, n, rmin, rmax, w, width, packed, exc, ac, exc_counts,
      ac_counts, dc);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_fused_encode_dpk() {
  return tile_ctas_per_sm(fused_encode_dpk_kernel, SMEM_BYTES);
}
