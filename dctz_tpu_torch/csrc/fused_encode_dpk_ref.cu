// Kernel L_ref: the reference one-pass DPK encode, a card-only check. It is
// the first design of kernel L, kept unchanged in its arithmetic so that it
// stays an implementation independent of the headers the kernels of the
// codec run on: the per-thread forward transform of common.cuh
// (scale_block, forward_dct) against the register-tiled one of dct_tile.cuh,
// and the per-byte DPK stages of dpk_tile.cuh against the word-wide ones of
// dpk_walk.cuh / dpk_stages.cuh. Nothing on an API path calls it; only
// chip_smoke.py and tests/test_torch_cuda.py do, through
// ops/research/_ref.py. Those hold L_ref equal to F -> pack_ids -> H (the
// tiled forward transform), B on A (verify off) equal to L_ref (B's word-wide
// stages) and the redesigned L equal to L_ref on all seven streams.
//
// Its streams are those of kernel L (fused_encode_dpk.cu), the port of
// dctz_tpu/ops/research/fused_encode_dpk.py (fused_encode_dpk, pallas_call
// at line 360, body _kernel lines 195-315); plain version:
// ops/research/fused_encode_dpk.py:_fused_encode_dpk_plain.
//
// One CUDA block per DPK tile (256 DCT blocks, 16384 samples), one thread per
// DCT block. The samples are staged coalesced into shared memory (rows padded
// to 65 floats) next to the 64x64 basis; each thread runs the per-thread
// scale and forward DCT of common.cuh, the same divisions and fmaf chains as
// the tiled transform, so the coefficients are bit-identical to F's. Each
// thread writes its coefficients over its row. The block then bins them as F
// does into the two id copies of dpk_tile.cuh and runs its per-byte stages:
// widths, packing, and the chunk-row compaction with AC escapes ranked among
// their chunk row's escapes alone (the rule of compaction.compact_chunked
// behind F). Zero padding of the tail tile bins to id 0.
//
// 116 KB of shared memory per block leave one 256-thread block per SM; it is
// a check, not a path, and its time is kept for the record only.

#include "dpk_tile.cuh"

namespace {

using namespace dctz;

constexpr int LD = 65;   // padded float row of the sample tile
constexpr int CW = 512;  // chunk width (n % 1024 == 0 always gives 512)
constexpr int CAP = 128; // exception and AC slots per chunk row
// shared memory: basis, samples (then coefficients), ids, nibbles, widths
constexpr size_t SMEM_BYTES = sizeof(float) * (BS * BS + TILE_B * LD) +
                              TILE_N + BS * LDN + sizeof(int) * BS;

__global__ void __launch_bounds__(TILE_B)
    fused_encode_dpk_ref_kernel(const float* __restrict__ x,
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
  extern __shared__ float smem[];
  float* sB = smem;                  // basis B[k][m]
  float* sX = sB + BS * BS;          // samples, then coefficients
  uint8_t* sId = reinterpret_cast<uint8_t*>(sX + TILE_B * LD);
  uint8_t* sN = sId + TILE_N;
  int* sW = reinterpret_cast<int*>(sN + BS * LDN);

  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long base = tile * TILE_N;
  const float sf = *sf_p;

  for (int i = tid; i < BS * BS; i += TILE_B) sB[i] = basis[i];
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const long long gi = base + i;
    sX[(i >> 6) * LD + (i & 63)] = gi < n ? x[gi] : 0.f;
  }
  __syncthreads();

  {
    float* row = sX + tid * LD;
    float xs[BS];
    scale_block(row, sf, xs);
    forward_dct(xs, sB, [&](int k, float c) { row[k] = c; });
  }
  __syncthreads();

  // bins as kernel F; the DC column and padding enter the tile as 0
  for (int i = tid; i < TILE_N; i += TILE_B) {
    const int blk = i >> 6, pos = i & 63;
    const float c = sX[blk * LD + pos];
    int v = 0;
    if (pos == 0) {
      dc_out[tile * TILE_B + blk] = c;
    } else if (base + i < n) {
      v = (c >= rmin && c <= rmax) ? bin_of(c, rmin, w) : ESCAPE;
    }
    put_id(sId, sN, i, v);
  }
  __syncthreads();

  select_widths(sN, sW);
  __syncthreads();
  if (tid < BS) width_out[tile * BS + tid] = static_cast<uint8_t>(sW[tid]);

  pack_rows(sN, sW, packed_out + tile * BS * 128);

  compact_chunks<false>(sId, sW, tile, CW, CAP, CAP, exc_out, ac_out, exc_cnt,
                        ac_cnt, [&](int blk, int pos) { return sX[blk * LD + pos]; });
}

}  // namespace

extern "C" int dctz_fused_encode_dpk_ref(const float* x, const float* basis,
                                     const float* sf, long long n, float rmin,
                                     float rmax, float w, uint8_t* width,
                                     uint8_t* packed, uint8_t* exc, float* ac,
                                     int* exc_counts, int* ac_counts,
                                     float* dc, void* stream) {
  cudaFuncSetAttribute(fused_encode_dpk_ref_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(SMEM_BYTES));
  const long long tiles = (n + TILE_N - 1) / TILE_N;
  fused_encode_dpk_ref_kernel<<<static_cast<unsigned>(tiles), TILE_B, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      x, basis, sf, n, rmin, rmax, w, width, packed, exc, ac, exc_counts,
      ac_counts, dc);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_fused_encode_dpk_ref() { return dctz::ctas_per_sm(fused_encode_dpk_ref_kernel, TILE_B, SMEM_BYTES); }
