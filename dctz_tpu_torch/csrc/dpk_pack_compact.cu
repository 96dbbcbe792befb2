// Kernel B: DPK width selection, bit packing, chunk-local compaction of the
// exception bytes and AC escapes, counts and DC extraction.
//
// Replaces the TPU tile body dctz_tpu/ops/dpk_fuse.py:_pack_tile (lines
// 288-418) with dctz_tpu/ops/shuffle.py:route_compact_unified, as run by
// encode_x_fused and encode_fused; the contract is idpack.pack_ids_with_ac.
// Plain version: ops/idpack.py:pack_ids_with_ac.
//
// One CUDA block per DPK tile (256 DCT blocks), 256 threads; the stages live
// in dpk_tile.cuh, which kernel L (fused_encode_dpk.cu) shares. The Mosaic
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

#include "dpk_tile.cuh"

namespace {

using namespace dctz;

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

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long blk0 = tile * TILE_B;

  for (int i = tid; i < TILE_N; i += TILE_B) {
    const int blk = i >> 6, pos = i & 63;
    const long long gblk = blk0 + blk;
    const long long gi = gblk * BS + pos;
    int v = 0;
    if (gblk < nblk && pos >= 1 && gi < n_valid) v = ids[gi];
    put_id(sId, sN, i, v);
  }
  __syncthreads();

  select_widths(sN, sW);
  __syncthreads();
  if (tid < BS) width_out[tile * BS + tid] = static_cast<uint8_t>(sW[tid]);

  pack_rows(sN, sW, packed_out + tile * BS * 128);

  // AC escapes among the first cape exceptions of each chunk row
  compact_chunks<true>(sId, sW, tile, cw, cape, cape, exc_out, ac_out, exc_cnt,
                       ac_cnt, [&](int blk, int pos) {
                         return vals[(blk0 + blk) * BS + pos];
                       });

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

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_dpk_pack_compact() { return dctz::ctas_per_sm(dpk_pack_compact_kernel, TILE_B, 0); }
