// Kernels H and I: stable compaction of the masked values of each chunk row
// into a fixed-capacity row, and its inverse.
//
// H chunk_compact replaces the TPU kernel dctz_tpu/ops/shuffle.py:compact_f32
// (line 422) and I chunk_expand replaces shuffle.expand (line 435), both
// launched through shuffle._call's pallas_call (line 371). Plain versions:
// ops/compaction.py:compact_rows and expand_rows.
//
//   H: mask (nc, cw) u8, vals (nc, cw) f32 -> rows (nc, capc) f32 holding the
//      row's masked values in position order, zero past them (values past the
//      capacity are dropped), and counts (nc,) i32, the TRUE per-row counts;
//   I: mask (nc, cw) u8, rows (nc, capc) 32-bit words -> out (nc, cw): the
//      r-th masked position of row c receives rows[c, r], everything else 0.
//
// The TPU kernels route values through log2(cw) conditional roll stages,
// because the TPU has no fast scatter or gather; that network is not carried
// over. Here one warp walks one chunk row 32 elements at a time: __ballot_sync
// marks the masked lanes, __popc of the lanes below gives each one its rank,
// and a running count carries the rank across steps (the machinery of kernel
// B's compaction). Any cw that is a multiple of 32 works (the TPU kernels
// need cw % 128 == 0; the JAX package sorts otherwise, with the same bytes).
//
// What bounds it: H reads 5 bytes per sample and writes 4 per slot (about
// 201 MB at 32Mi samples with 128-slot rows of 512: 0.060 ms at 3.35 TB/s); I
// reads 1 byte per sample and 4 per slot and writes 4 per sample (also about
// 201 MB). No arithmetic to speak of: bytes. Each warp's steps depend on the
// running count, so latency may show for wide rows (not measured).

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int WARPS = 8;  // chunk rows per CUDA block, one warp each

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_kernel(const uint8_t* __restrict__ mask,
                         const float* __restrict__ vals, long long nc, int cw,
                         int capc, float* __restrict__ rows,
                         int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= nc) return;  // the whole warp leaves together
  const uint8_t* m = mask + row * cw;
  const float* v = vals + row * cw;
  float* out = rows + row * capc;
  const unsigned below = lanes_below();
  int count = 0;
  for (int e0 = 0; e0 < cw; e0 += 32) {
    const int e = e0 + lane;
    const bool on = m[e] != 0;
    const unsigned b = __ballot_sync(FULL, on);
    const int rank = count + __popc(b & below);
    if (on && rank < capc) out[rank] = v[e];
    count += __popc(b);
  }
  for (int q = min(count, capc) + lane; q < capc; q += 32) out[q] = 0.f;
  if (lane == 0) counts[row] = count;
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_expand_kernel(const uint8_t* __restrict__ mask,
                        const unsigned* __restrict__ rows, long long nc,
                        int cw, int capc, unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= nc) return;
  const uint8_t* m = mask + row * cw;
  const unsigned* r = rows + row * capc;
  unsigned* o = out + row * cw;
  const unsigned below = lanes_below();
  int count = 0;
  for (int e0 = 0; e0 < cw; e0 += 32) {
    const int e = e0 + lane;
    const bool on = m[e] != 0;
    const unsigned b = __ballot_sync(FULL, on);
    const int rank = count + __popc(b & below);
    o[e] = (on && rank < capc) ? r[rank] : 0u;
    count += __popc(b);
  }
}

unsigned grid_of(long long nc) {
  return static_cast<unsigned>((nc + WARPS - 1) / WARPS);
}

}  // namespace

extern "C" int dctz_chunk_compact(const uint8_t* mask, const float* vals,
                                  long long nc, int cw, int capc, float* rows,
                                  int* counts, void* stream) {
  chunk_compact_kernel<<<grid_of(nc), WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      mask, vals, nc, cw, capc, rows, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dctz_chunk_expand(const uint8_t* mask, const unsigned* rows,
                                 long long nc, int cw, int capc, unsigned* out,
                                 void* stream) {
  chunk_expand_kernel<<<grid_of(nc), WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      mask, rows, nc, cw, capc, out);
  return static_cast<int>(cudaGetLastError());
}
