// Kernel B: DPK width selection, bit packing, chunk-local compaction of the
// exception bytes and AC escapes, counts and DC extraction.
//
// Replaces the TPU tile body dctz_tpu/ops/dpk_fuse.py:_pack_tile (lines
// 288-418) with dctz_tpu/ops/shuffle.py:route_compact_unified, as run by
// encode_x_fused and encode_fused; the contract is idpack.pack_ids_with_ac.
// Plain version: ops/idpack.py:pack_ids_with_ac.
//
// One CUDA block per DPK tile (256 DCT blocks), 256 threads. The Mosaic
// workarounds of the TPU kernel (roll networks for compaction, identity
// matmuls as transposes, byte-building matmuls) become plain operations: the
// tile's validity-masked ids sit in shared memory block-major (for the chunk
// rows) and as a tile-major nibble copy (for widths and packing, so a warp
// reads consecutive bytes); widths are warp reductions; packing is shifts;
// the stable compaction is a warp walking a chunk row 32 elements at a time,
// ranking its masked lanes with __ballot_sync/__popc.
//
// What bounds it: about 1.3 bytes of input per sample (the id byte, and the
// float value only at escapes and DC) against about 0.3 bytes of output, so
// device memory is not the limit; the serial walk of each chunk row by one
// warp (cw/32 dependent ballot steps) and the byte-wise shared-memory
// traffic are. Fusing it with kernel A, so the ids never leave the SM, is
// later work.

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int LDN = TILE_B + 4;  // padded row of the tile-major nibble copy

__global__ void __launch_bounds__(TILE_B)
    dpk_pack_compact_kernel(const uint8_t* __restrict__ ids,
                            const float* __restrict__ vals, long long nblk,
                            long long n_valid, int cw, int cape,
                            uint8_t* __restrict__ width_out,
                            uint8_t* __restrict__ packed_out,
                            uint8_t* __restrict__ exc_out,
                            float* __restrict__ ac_out,
                            int* __restrict__ exc_cnt,
                            int* __restrict__ ac_cnt,
                            float* __restrict__ dc_out) {
  __shared__ uint8_t sId[TILE_N];     // block-major ids (masked)
  __shared__ uint8_t sN[BS * LDN];    // tile-major nibbles min(id, 15)
  __shared__ int sW[BS];

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long tile = blockIdx.x;
  const long long blk0 = tile * TILE_B;

  for (int i = tid; i < TILE_N; i += TILE_B) {
    const int blk = i >> 6, pos = i & 63;
    const long long gblk = blk0 + blk;
    const long long gi = gblk * BS + pos;
    int v = 0;
    if (gblk < nblk && pos >= 1 && gi < n_valid) v = ids[gi];
    sId[i] = static_cast<uint8_t>(v);
    sN[pos * LDN + blk] = static_cast<uint8_t>(min(v, 15));
  }
  __syncthreads();

  // width per position: cost w*256 + 8*#(nib >= 2^w - 1), first minimum
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
  __syncthreads();
  if (tid < BS) width_out[tile * BS + tid] = static_cast<uint8_t>(sW[tid]);

  // bit packing: row p holds the tile's 256 values at width w (128 bytes,
  // zero past 32*w); w = 3 packs 8 values into 3 bytes (little-endian)
  for (int idx = tid; idx < BS * 128; idx += TILE_B) {
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
    packed_out[(tile * BS + p) * 128 + i] = static_cast<uint8_t>(byte);
  }

  // chunk rows: stable compaction of exception bytes (rank < cape) and of
  // the AC escapes among them, one warp per row
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
      const bool esc = m && id == ESCAPE && rank < cape;
      const unsigned ba = __ballot_sync(FULL, esc);
      const int arank = acount + __popc(ba & below);
      if (esc && arank < cape)
        ac_out[row * cape + arank] = vals[(blk0 + blk) * BS + pos];
      atotal += __popc(__ballot_sync(FULL, id == ESCAPE));
      ecount += __popc(bm);
      acount += __popc(ba);
    }
    for (int q = min(ecount, cape) + lane; q < cape; q += 32) exc_out[row * cape + q] = 0;
    for (int q = min(acount, cape) + lane; q < cape; q += 32) ac_out[row * cape + q] = 0.f;
    if (lane == 0) {
      exc_cnt[row] = ecount;
      ac_cnt[row] = atotal;
    }
  }

  // DC: the value at column 0 of each block
  {
    const long long gblk = blk0 + tid;
    dc_out[gblk] = gblk < nblk ? vals[gblk * BS] : 0.f;
  }
}

}  // namespace

extern "C" int dctz_dpk_pack_compact(const uint8_t* ids, const float* vals,
                                     long long nblk, long long n_valid, int cw,
                                     int cape, uint8_t* width, uint8_t* packed,
                                     uint8_t* exc, float* ac, int* exc_counts,
                                     int* ac_counts, float* dc, void* stream) {
  const long long tiles = (nblk + TILE_B - 1) / TILE_B;
  dpk_pack_compact_kernel<<<static_cast<unsigned>(tiles), TILE_B, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      ids, vals, nblk, n_valid, cw, cape, width, packed, exc, ac, exc_counts,
      ac_counts, dc);
  return static_cast<int>(cudaGetLastError());
}
