// Kernel C: unpack the DPK nibbles at their stored widths, then expand the
// exception bytes and the AC escape values back to their positions.
//
// Replaces the unpack/route half of the TPU decode kernel
// dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 116-210, called from
// decode_fused) with dctz_tpu/ops/shuffle.py:route_expand; the contract is
// idpack.unpack_ids plus the chunked AC expansion of quantize.decode.
// Plain version: ops/dpk_fuse.py:_dpk_unpack_expand_plain.
//
// One CUDA block per DPK tile, 256 threads. The byte-gather matmuls and the
// identity-matmul transpose of the TPU kernel become shifts on a shared-memory
// copy of the tile's packed rows, written block-major into shared memory; the
// butterfly expansion becomes one warp per chunk row ranking its exception
// (and then escape) lanes with __ballot_sync/__popc and reading the r-th
// stored byte (value) directly.
//
// What bounds it: about 0.3 bytes read and 5 bytes written per sample (the id
// byte and a dense float AC grid for kernel D), so device-memory writes; the
// dense AC grid exists only because C and D are separate launches, and fusing
// them is later work.

#include "common.cuh"

namespace {

using namespace dctz;

__global__ void __launch_bounds__(TILE_B)
    dpk_unpack_expand_kernel(const uint8_t* __restrict__ width,
                             const uint8_t* __restrict__ packed,
                             const uint8_t* __restrict__ exc_rows,
                             const float* __restrict__ ac_rows, long long nblk,
                             long long nc, long long n_stream, int cw, int cape,
                             int capc, uint8_t* __restrict__ ids_out,
                             float* __restrict__ acv_out) {
  __shared__ uint8_t sP[BS * 128];   // the tile's packed rows
  __shared__ uint8_t sN[TILE_N];     // block-major nibbles
  __shared__ int sW[BS];

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long tile = blockIdx.x;
  const long long blk0 = tile * TILE_B;

  {
    const uint4* src = reinterpret_cast<const uint4*>(packed + tile * BS * 128);
    uint4* dst = reinterpret_cast<uint4*>(sP);
    for (int i = tid; i < BS * 128 / 16; i += TILE_B) dst[i] = src[i];
  }
  if (tid < BS) sW[tid] = width[tile * BS + tid];
  __syncthreads();

  // unpack: value k of position row p sits at bit k*w of the row
  for (int idx = tid; idx < TILE_N; idx += TILE_B) {
    const int p = idx >> 8, k = idx & 255;
    const int wd = sW[p];
    const uint8_t* row = sP + p * 128;
    int nib = 0;
    if (wd > 0) {
      const int bit = k * wd, by = bit >> 3;
      const int lo = row[by];
      const int hi = (wd == 3 && by + 1 < 128) ? row[by + 1] : 0;
      nib = ((lo | (hi << 8)) >> (bit & 7)) & ((1 << wd) - 1);
    }
    sN[k * BS + p] = static_cast<uint8_t>(nib);
  }
  __syncthreads();

  // chunk rows: exceptions (nib == 2^w - 1) take the next stored byte; then
  // escapes (id == ESCAPE off the DC column) take the next stored AC value
  const int g = cw / BS;
  const int cpt = TILE_N / cw;
  const unsigned below = lanes_below();
  for (int r = wid; r < cpt; r += TILE_B / 32) {
    const long long row = tile * cpt + r;
    const bool have = row < nc;
    int ecount = 0, acount = 0;
    for (int e0 = 0; e0 < cw; e0 += 32) {
      const int e = e0 + lane;
      const int blk = r * g + (e >> 6), pos = e & 63;
      const long long gblk = blk0 + blk;
      const long long gi = gblk * BS + pos;
      const int nib = sN[blk * BS + pos];
      const int wd = sW[pos];
      const bool m = wd > 0 && nib == (1 << wd) - 1;
      const unsigned bm = __ballot_sync(FULL, m);
      const int rank = ecount + __popc(bm & below);
      int id = nib;
      if (m) id = (have && rank < cape) ? exc_rows[row * cape + rank] : 0;
      if (pos == 0) id = ESCAPE;
      const bool esc = pos >= 1 && id == ESCAPE && gi < n_stream;
      const unsigned ba = __ballot_sync(FULL, esc);
      const int arank = acount + __popc(ba & below);
      const float av = (esc && have && arank < capc) ? ac_rows[row * capc + arank] : 0.f;
      if (gblk < nblk) {
        ids_out[gi] = static_cast<uint8_t>(id);
        acv_out[gi] = av;
      }
      ecount += __popc(bm);
      acount += __popc(ba);
    }
  }
}

}  // namespace

extern "C" int dctz_dpk_unpack_expand(const uint8_t* width,
                                      const uint8_t* packed,
                                      const uint8_t* exc_rows,
                                      const float* ac_rows, long long nblk,
                                      long long nc, long long n_stream, int cw,
                                      int cape, int capc, uint8_t* ids,
                                      float* acv, void* stream) {
  const long long tiles = (nblk + TILE_B - 1) / TILE_B;
  dpk_unpack_expand_kernel<<<static_cast<unsigned>(tiles), TILE_B, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      width, packed, exc_rows, ac_rows, nblk, nc, n_stream, cw, cape, capc, ids,
      acv);
  return static_cast<int>(cudaGetLastError());
}
