// The per-byte DPK tile stages of kernel L_ref (fused_encode_dpk_ref.cu, the
// card-only reference): width selection, bit packing and the chunk-row
// compaction of exception bytes and AC escapes, on a tile of 256 DCT blocks
// whose ids a CUDA block of 256 threads holds in shared memory, a byte per
// element. Kernels B and L run the word-wide stages of dpk_stages.cuh
// instead; L_ref keeps these, so that it stays an implementation independent
// of theirs, which chip_smoke.py holds B and L to.
//
// The ids sit there twice: block-major (sId, TILE_N bytes, masked: 0 at the
// DC column and at padding) for the chunk rows, and as a tile-major copy of
// the nibbles min(id, 15) (sN, rows of LDN bytes) for widths and packing, so
// that a warp reads consecutive bytes.
#pragma once

#include "common.cuh"

namespace dctz {

constexpr int LDN = TILE_B + 4;  // padded row of the tile-major nibble copy

// Stage the masked id v of element i (block-major) into both copies.
__device__ __forceinline__ void put_id(uint8_t* __restrict__ sId,
                                       uint8_t* __restrict__ sN, int i, int v) {
  sId[i] = static_cast<uint8_t>(v);
  sN[(i & 63) * LDN + (i >> 6)] = static_cast<uint8_t>(min(v, 15));
}

// Width per position: cost w*256 + 8*#(nib >= 2^w - 1), first minimum; each
// warp takes 8 positions, warp reductions count the candidates.
__device__ __forceinline__ void select_widths(const uint8_t* __restrict__ sN,
                                              int* __restrict__ sW) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int q = 0; q < BS / 8; ++q) {
    const int p = wid * (BS / 8) + q;
    int c1 = 0, c3 = 0, c7 = 0, c15 = 0;
    for (int k = lane; k < TILE_B; k += 32) {
      const int nb = sN[p * LDN + k];
      c1 += nb >= 1;
      c3 += nb >= 3;
      c7 += nb >= 7;
      c15 += nb >= 15;
    }
    c1 = __reduce_add_sync(FULL, c1);
    c3 = __reduce_add_sync(FULL, c3);
    c7 = __reduce_add_sync(FULL, c7);
    c15 = __reduce_add_sync(FULL, c15);
    if (lane == 0) {
      const int cnt[4] = {c1, c3, c7, c15};
      int best = c1 == 0 ? 0 : (1 << 30), wd = 0;
      for (int wb = 1; wb <= 4; ++wb) {
        const int cost = wb * TILE_B + 8 * cnt[wb - 1];
        if (cost < best) {
          wd = wb;
          best = cost;
        }
      }
      sW[p] = wd;
    }
  }
}

// Bit packing: row p of the tile (packed_tile + 128 * p) holds its 256
// values at width w (128 bytes, zero past 32*w); w = 3 packs 8 values into 3
// bytes (little-endian).
__device__ __forceinline__ void pack_rows(const uint8_t* __restrict__ sN,
                                          const int* __restrict__ sW,
                                          uint8_t* __restrict__ packed_tile) {
  for (int idx = threadIdx.x; idx < BS * 128; idx += TILE_B) {
    const int p = idx >> 7, i = idx & 127;
    const int wd = sW[p];
    const uint8_t* row = sN + p * LDN;
    unsigned byte = 0;
    if (wd == 3) {
      if (i < 96) {
        const int grp = i / 3, part = i % 3;
        unsigned w24 = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w24 |= static_cast<unsigned>(min(static_cast<int>(row[8 * grp + j]), 7)) << (3 * j);
        byte = (w24 >> (8 * part)) & 255u;
      }
    } else if (wd > 0 && i < 32 * wd) {
      const int per = 8 / wd, thr = (1 << wd) - 1;
      for (int j = 0; j < per; ++j)
        byte |= static_cast<unsigned>(min(static_cast<int>(row[i * per + j]), thr)) << (j * wd);
    }
    packed_tile[p * 128 + i] = static_cast<uint8_t>(byte);
  }
}

// Chunk rows of the tile (cw elements each, block-major), one warp per row:
// stable compaction of the exception bytes (nib >= 2^w - 1) into cape slots
// and of the AC escapes (id == ESCAPE) into capc slots, zero-filled, with
// the true counts. AC_AMONG_EXC: an escape is kept only if its exception
// rank is < cape (kernel B, shuffle.route_compact_unified's rule); else by
// its rank among the row's escapes alone (kernel L, compact_chunked's rule).
// val(blk, pos) returns the value of a tile element.
template <bool AC_AMONG_EXC, class Val>
__device__ __forceinline__ void compact_chunks(
    const uint8_t* __restrict__ sId, const int* __restrict__ sW,
    long long tile, int cw, int cape, int capc, uint8_t* __restrict__ exc_out,
    float* __restrict__ ac_out, int* __restrict__ exc_cnt,
    int* __restrict__ ac_cnt, Val&& val) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = cw / BS;
  const int cpt = TILE_N / cw;
  const unsigned below = lanes_below();
  for (int r = wid; r < cpt; r += TILE_B / 32) {
    const long long row = tile * cpt + r;
    int ecount = 0, acount = 0, atotal = 0;
    for (int e0 = 0; e0 < cw; e0 += 32) {
      const int e = e0 + lane;
      const int blk = r * g + (e >> 6), pos = e & 63;
      const int id = sId[blk * BS + pos];
      const int wd = sW[pos];
      const bool m = wd > 0 && min(id, 15) >= (1 << wd) - 1;
      const unsigned bm = __ballot_sync(FULL, m);
      const int rank = ecount + __popc(bm & below);
      if (m && rank < cape) exc_out[row * cape + rank] = static_cast<uint8_t>(id);
      const bool esc = AC_AMONG_EXC ? (m && id == ESCAPE && rank < cape) : id == ESCAPE;
      const unsigned ba = __ballot_sync(FULL, esc);
      const int arank = acount + __popc(ba & below);
      if (esc && arank < capc) ac_out[row * capc + arank] = val(blk, pos);
      atotal += __popc(__ballot_sync(FULL, id == ESCAPE));
      ecount += __popc(bm);
      acount += __popc(ba);
    }
    for (int q = min(ecount, cape) + lane; q < cape; q += 32) exc_out[row * cape + q] = 0;
    for (int q = min(acount, capc) + lane; q < capc; q += 32) ac_out[row * capc + q] = 0.f;
    if (lane == 0) {
      exc_cnt[row] = ecount;
      ac_cnt[row] = atotal;
    }
  }
}

}  // namespace dctz
