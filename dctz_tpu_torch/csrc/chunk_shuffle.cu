// Kernels H, I, J and K: stable compaction of the masked values of each chunk
// row into a fixed-capacity row, its inverse, and the two compactions of
// bytes.
//
// H chunk_compact replaces the TPU kernel dctz_tpu/ops/shuffle.py:compact_f32
// (line 422), I chunk_expand replaces shuffle.expand (line 435), J
// chunk_compact_unified replaces shuffle.compact_unified (line 392, body
// _k_compact_unified and route_compact_unified, lines 170-240) and K
// chunk_compact_bytes replaces shuffle.compact_bytes (line 409, body
// _k_compact_bytes, lines 243-261), all launched through shuffle._call's
// pallas_call (line 371). Plain versions: ops/compaction.py:compact_rows and
// expand_rows (J: ops/shuffle.py:_compact_unified_plain, two compact_rows).
//
//   H: mask (nc, cw) u8, vals (nc, cw) f32 -> rows (nc, capc) f32 holding the
//      row's masked values in position order, zero past them (values past the
//      capacity are dropped), and counts (nc,) i32, the TRUE per-row counts;
//   K: the same on u8 values, rows only;
//   I: mask (nc, cw) u8, rows (nc, capc) 32-bit words -> out (nc, cw): the
//      r-th masked position of row c receives rows[c, r], everything else 0;
//   J: mask (nc, cw) u8, id bytes (nc, cw) u8, vals (nc, cw) f32 -> exc
//      (nc, cape) u8, the masked id bytes compacted as by K, and ac (nc, capc)
//      f32, the values at the masked positions whose id byte is ESCAPE and
//      whose exception rank is < cut, compacted in position order.
//
// The TPU kernels route values through log2(cw) conditional roll stages,
// because the TPU has no fast scatter or gather; that network is not carried
// over. Here one warp walks one chunk row 32 elements at a time: __ballot_sync
// marks the masked lanes, __popc of the lanes below gives each one its rank,
// and a running count carries the rank across steps (the machinery of kernel
// B's compaction). J ranks the exceptions and the escapes among them in the
// same walk, with two ballots a step. Any cw that is a multiple of 32 works
// (the TPU kernels need cw % 128 == 0; the JAX package sorts otherwise, with
// the same bytes).
//
// What bounds it: bytes, with no arithmetic to speak of. Each kernel reads
// the mask, 1 byte per sample, and a value only where it keeps one: H and K
// the first capc masked values of a row, I one row slot per masked position,
// J the id bytes of the first max(cape, cut) exceptions of a row and the AC
// values it keeps. H, J and K write their rows, I 4 bytes per sample. Each
// warp's steps depend on the running count, so latency may show for wide
// rows (not measured).

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int WARPS = 8;  // chunk rows per CUDA block, one warp each

// The stable compaction of one chunk row by its warp (kernels H and K);
// counts may be null.
template <class T>
__device__ __forceinline__ void compact_row(const uint8_t* __restrict__ mask,
                                            const T* __restrict__ vals,
                                            long long nc, int cw, int capc,
                                            T* __restrict__ rows,
                                            int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= nc) return;  // the whole warp leaves together
  const uint8_t* m = mask + row * cw;
  const T* v = vals + row * cw;
  T* out = rows + row * capc;
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
  for (int q = min(count, capc) + lane; q < capc; q += 32) out[q] = T(0);
  if (counts != nullptr && lane == 0) counts[row] = count;
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_kernel(const uint8_t* __restrict__ mask,
                         const float* __restrict__ vals, long long nc, int cw,
                         int capc, float* __restrict__ rows,
                         int* __restrict__ counts) {
  compact_row(mask, vals, nc, cw, capc, rows, counts);
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_bytes_kernel(const uint8_t* __restrict__ mask,
                               const uint8_t* __restrict__ vals, long long nc,
                               int cw, int capc, uint8_t* __restrict__ rows) {
  compact_row(mask, vals, nc, cw, capc, rows, static_cast<int*>(nullptr));
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_unified_kernel(const uint8_t* __restrict__ mask,
                                 const uint8_t* __restrict__ idb,
                                 const float* __restrict__ vals, long long nc,
                                 int cw, int cape, int capc, int cut,
                                 uint8_t* __restrict__ exc,
                                 float* __restrict__ ac) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= nc) return;
  const uint8_t* m = mask + row * cw;
  const uint8_t* ib = idb + row * cw;
  const float* v = vals + row * cw;
  uint8_t* eo = exc + row * cape;
  float* ao = ac + row * capc;
  const unsigned below = lanes_below();
  const int need = max(cape, cut);  // exception ranks whose id byte is used
  int ecount = 0, acount = 0;
  for (int e0 = 0; e0 < cw; e0 += 32) {
    const int e = e0 + lane;
    const bool on = m[e] != 0;
    const unsigned bm = __ballot_sync(FULL, on);
    const int rank = ecount + __popc(bm & below);
    const int id = (on && rank < need) ? ib[e] : 0;
    if (on && rank < cape) eo[rank] = static_cast<uint8_t>(id);
    const bool esc = on && id == ESCAPE && rank < cut;
    const unsigned ba = __ballot_sync(FULL, esc);
    const int arank = acount + __popc(ba & below);
    if (esc && arank < capc) ao[arank] = v[e];
    ecount += __popc(bm);
    acount += __popc(ba);
  }
  for (int q = min(ecount, cape) + lane; q < cape; q += 32) eo[q] = 0;
  for (int q = min(acount, capc) + lane; q < capc; q += 32) ao[q] = 0.f;
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

extern "C" int dctz_chunk_compact_bytes(const uint8_t* mask, const uint8_t* vals,
                                        long long nc, int cw, int capc,
                                        uint8_t* rows, void* stream) {
  chunk_compact_bytes_kernel<<<grid_of(nc), WARPS * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      mask, vals, nc, cw, capc, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dctz_chunk_compact_unified(const uint8_t* mask,
                                          const uint8_t* idb, const float* vals,
                                          long long nc, int cw, int cape,
                                          int capc, int cut, uint8_t* exc,
                                          float* ac, void* stream) {
  chunk_compact_unified_kernel<<<grid_of(nc), WARPS * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      mask, idb, vals, nc, cw, cape, capc, cut, exc, ac);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration.
extern "C" int dctz_ctas_per_sm_chunk_compact() { return dctz::ctas_per_sm(chunk_compact_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_expand() { return dctz::ctas_per_sm(chunk_expand_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_compact_unified() { return dctz::ctas_per_sm(chunk_compact_unified_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_compact_bytes() { return dctz::ctas_per_sm(chunk_compact_bytes_kernel, WARPS * 32, 0); }
