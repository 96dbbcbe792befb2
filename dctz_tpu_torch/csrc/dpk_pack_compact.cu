// Kernel B: DPK width selection, bit packing, chunk-local compaction of the
// exception bytes and AC escapes, counts and DC extraction.
//
// Replaces the TPU tile body dctz_tpu/ops/dpk_fuse.py:_pack_tile (lines
// 288-418) with dctz_tpu/ops/shuffle.py:route_compact_unified, as run by
// encode_x_fused and encode_fused; the contract is idpack.pack_ids_with_ac.
// Plain version: ops/idpack.py:pack_ids_with_ac.
//
// What bounds it on the H100: by bytes, little. It must read the id bytes
// (1 per sample), the DC value of each block and the escapes it keeps, and
// write the packed rows, the exception and AC rows at their capacity
// (zero-filled) and the DC: about 97 MB for 32Mi samples at capacity 128,
// 0.03 ms at 3.35 TB/s. Its work is byte-granular, and the instructions
// and latencies of that work bound it: the earlier kernel spent half its
// time in the chunk-row walk (kernels/stage_split.py times each stage). So
// the design keeps the work in 32-bit words and the phases overlapped:
// - Persistent CTAs of 256 threads (resident CTAs per SM x SMs) walk the
//   tiles of 256 DCT blocks. The next tile's 16 KB of ids and its 256 DC
//   values arrive by cp.async into the other of two buffers while this one
//   is worked.
// - Widths, the transpose, packing and the chunk-row walk are the
//   word-wide stages of dpk_stages.cuh, which kernel L (fused_encode_dpk.cu)
//   shares: ids and thresholds in 32-bit words, a __byte_perm transpose
//   into a position-major nibble copy, packing from words with 8- and
//   16-byte stores, 16 ids per lane per 512-sample step of the walk, one
//   shuffle scan of packed counts per step. B keeps the escapes among a
//   chunk row's first cape exceptions (walk_exceptions<true>).
// The card-only reference L_ref (fused_encode_dpk_ref.cu) keeps the earlier
// per-byte stages of dpk_tile.cuh, an independent implementation that
// chip_smoke.py holds B to.

#include "dpk_stages.cuh"

namespace {

using namespace dctz;
using walk::Walk;

constexpr int MIN_CTAS = 3;  // resident CTAs per SM that __launch_bounds__ asks

struct Args {
  const uint8_t* ids;
  const float* vals;
  long long nblk, n_valid;
  int cw, cape;
  uint8_t* width_out;
  uint8_t* packed_out;
  uint8_t* exc_out;
  float* ac_out;
  int* exc_cnt;
  int* ac_cnt;
  float* dc_out;
};

struct __align__(16) Smem {
  uint8_t raw[2][TILE_N];             // ids as loaded (block rows), two buffers
  float dc[2][TILE_B];                // the blocks' DC values, as loaded
  stages::Smem st;                    // nibble copy, counts, widths
};

// 4 bytes from device memory into shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// Start loading tile t's ids into raw and its blocks' DC values into dc;
// zeros past nblk.
__device__ __forceinline__ void load_tile_async(uint8_t* __restrict__ raw,
                                                float* __restrict__ dc,
                                                const Args& a, long long t,
                                                int tid) {
#pragma unroll
  for (int s = 0; s < TILE_N / 16 / TILE_B; ++s) {
    const int i = tid + s * TILE_B, kb = i >> 2, col = 16 * (i & 3);
    const long long gblk = t * TILE_B + kb;
    if (gblk < a.nblk)
      tile::cp_async16(raw + kb * BS + col, a.ids + gblk * BS + col);
    else
      *reinterpret_cast<uint4*>(raw + kb * BS + col) = make_uint4(0, 0, 0, 0);
  }
  const long long gblk = t * TILE_B + tid;
  if (gblk < a.nblk)
    cp_async4(dc + tid, a.vals + gblk * BS);
  else
    dc[tid] = 0.f;
  tile::cp_async_commit();
}

__global__ void __launch_bounds__(TILE_B, MIN_CTAS)
    dpk_pack_compact_kernel(const Args a) {
  __shared__ Smem s;
  const int tid = threadIdx.x, wid = tid >> 5;
  const long long tiles = (a.nblk + TILE_B - 1) / TILE_B;
  const int cpt = TILE_N / a.cw;
  const Walk wk(a.cw);

  load_tile_async(s.raw[0], s.dc[0], a, blockIdx.x, tid);
  int b = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, b ^= 1) {
    const long long blk0 = t * TILE_B;
    tile::cp_async_wait_all();
    __syncthreads();  // tile t landed; last tile's readers are done
    if (t + gridDim.x < tiles)
      load_tile_async(s.raw[b ^ 1], s.dc[b ^ 1], a, t + gridDim.x, tid);
    const uint8_t* raw = s.raw[b];
    const int valid = static_cast<int>(
        max(min(a.n_valid - blk0 * BS, static_cast<long long>(TILE_N)), 0LL));
    const bool full = valid == TILE_N;

    // the word-wide stages of dpk_stages.cuh: nibble copy and threshold
    // counts, widths, packing; then the chunk rows: exceptions (nib >= 2^w -
    // 1) into cape slots and the AC escapes among the first cape
    // exceptions, true counts
    stages::nibbles_and_counts(raw, s.st, tid, full, valid);
    __syncthreads();
    stages::select_widths(s.st, tid, a.width_out + t * BS);
    __syncthreads();
    stages::pack_tile(s.st, tid, a.packed_out + t * BS * 128);
    const long long row0 = t * cpt;
    stages::walk_exceptions<true>(raw, s.st, wk, wid, full, valid, a.cape,
                                  a.exc_out + row0 * a.cape, a.exc_cnt + row0,
                                  a.ac_out + row0 * a.cape, a.ac_cnt + row0,
                                  a.vals + t * TILE_N);

    a.dc_out[blk0 + tid] = s.dc[b][tid];
  }
}

}  // namespace

extern "C" int dctz_dpk_pack_compact(const uint8_t* ids, const float* vals,
                                     long long nblk, long long n_valid, int cw,
                                     int cape, uint8_t* width, uint8_t* packed,
                                     uint8_t* exc, float* ac, int* exc_counts,
                                     int* ac_counts, float* dc, void* stream) {
  static int cache[tile::MAX_DEVICES] = {};
  const long long tiles = (nblk + TILE_B - 1) / TILE_B;
  if (tiles == 0) return 0;
  const Args a{ids, vals, nblk, n_valid, cw, cape, width, packed,
               exc, ac,   exc_counts, ac_counts, dc};
  const long long grid = tile::persistent_grid(dpk_pack_compact_kernel, 0, tiles, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  dpk_pack_compact_kernel<<<static_cast<unsigned>(grid), TILE_B, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_dpk_pack_compact() {
  return tile::tile_ctas_per_sm(dpk_pack_compact_kernel, 0);
}
