// Kernel C: unpack the DPK nibbles at their stored widths, then expand the
// exception bytes and the AC escape values back to their positions.
//
// Replaces the unpack/route half of the TPU decode kernel
// dctz_tpu/ops/dpk_fuse.py:_make_kernel (lines 116-210, called from
// decode_fused) with dctz_tpu/ops/shuffle.py:route_expand; the contract is
// idpack.unpack_ids plus the chunked AC expansion of quantize.decode.
// Plain version: ops/dpk_fuse.py:_dpk_unpack_expand_plain.
//
// What bounds it on the H100: by bytes, writes. Per sample it reads about
// 0.3 bytes (packed rows, exception and AC rows) and writes 5 (the id byte,
// and a dense float AC grid that only kernel D reads): 0.063 ms for 32Mi
// samples at 3.35 TB/s. The dense grid exists because C and D are separate
// launches (kernel M is the fused decode). In practice the chunk-row walk's
// instruction count bounds it: the earlier kernel lost its time to the
// walk (dependent 32-sample steps) and to the 16-way conflicted stores of a
// block-major nibble copy (kernels/stage_split.py times each stage).
//
// The design:
// - Persistent CTAs of 256 threads (resident CTAs per SM x SMs) walk the
//   tiles of 256 DCT blocks. While a CTA works one tile, cp.async brings in
//   the next one's packed rows (8 KB), widths and, in the staged
//   instantiation, its chunk rows of exception bytes and AC values, into
//   the other of two buffers.
// - No block-major nibble copy: the walk takes the nibbles straight from
//   the packed rows in shared memory, a 32-bit field of 8 values per row
//   and step (a funnel shift of two words). The rows' 16-byte chunks are
//   XOR-swizzled by row, so the 16 rows a half-warp reads at one offset fall
//   on 8 chunk columns: 2-way, where the plain layout is 16-way.
// - The walk (dpk_walk.cuh): a warp step covers 512 samples, a lane 4
//   consecutive positions of one block in each of 4 sub-steps, so a lane
//   holds 16 ids as 4 words. Exceptions and escapes are exact byte tests in
//   words; one shuffle scan of packed counts ranks a whole step; a lane
//   visits only its set bits. Each sub-step's ids go out in one 32-bit
//   store per lane and its AC values as one zero 16-byte store per lane
//   (128 and 512 bytes per warp store) with each escape's value stored over
//   it; in the staged instantiation no store waits on a device-memory load.
// - dpk_unpack_expand_kernel stages the chunk rows when a tile's rows fit
//   the budget (cape * rows <= 4 KB, capc * rows * 4 <= 16 KB: capacities up
//   to 128 at cw = 512, the API's width) and their rows are 16-byte
//   multiples; dpk_unpack_expand_wide_kernel reads them from device memory
//   (the overflow tiers up to cw, the narrow chunk widths of short
//   containers), which puts a load on the path of each rank.

#include "dpk_walk.cuh"

namespace {

using namespace dctz;
using walk::Walk;
using walk::pack4;

constexpr int MIN_CTAS = 3;  // resident CTAs per SM that __launch_bounds__ asks
constexpr int ROW_BYTES = 128;                // one packed row
constexpr int PACKED_BYTES = BS * ROW_BYTES;  // a tile's packed rows
constexpr int EXC_BUDGET = 4096;   // staged exception bytes per tile, at most
constexpr int AC_BUDGET = 16384;   // staged AC bytes per tile, at most

struct Args {
  const uint8_t* width;
  const uint8_t* packed;
  const uint8_t* exc_rows;
  const float* ac_rows;
  long long nblk, nc, n_stream;
  int cw, cape, capc;
  uint8_t* ids_out;
  float* acv_out;
};

__host__ __device__ __forceinline__ int exc_stage_bytes(int cpt, int cape) {
  return (cpt * cape + 15) / 16 * 16;
}

// Bytes of one tile's buffer: packed rows, widths, [exception rows, AC rows].
__host__ __device__ __forceinline__ int buffer_bytes(bool staged, int cw,
                                                     int cape, int capc) {
  const int cpt = TILE_N / cw;
  return PACKED_BYTES + BS +
         (staged ? exc_stage_bytes(cpt, cape) + cpt * capc * 4 : 0);
}

// Offset of byte b of packed row p in a buffer.
__device__ __forceinline__ int swz(int p, int b) {
  return p * ROW_BYTES + (b ^ (((p >> 2) & 7) << 4));
}

// Start loading tile t into buf.
template <bool STAGED>
__device__ __forceinline__ void load_tile_async(uint8_t* __restrict__ buf,
                                                const Args& a, long long t,
                                                int tid) {
  const uint8_t* src = a.packed + t * PACKED_BYTES;
#pragma unroll
  for (int s = 0; s < PACKED_BYTES / 16 / TILE_B; ++s) {
    const int i = tid + s * TILE_B, p = i >> 3, c = i & 7;
    tile::cp_async16(buf + swz(p, 16 * c), src + 16 * i);
  }
  if (tid < BS / 16)
    tile::cp_async16(buf + PACKED_BYTES + 16 * tid, a.width + t * BS + 16 * tid);
  if constexpr (STAGED) {
    const int cpt = TILE_N / a.cw;
    const long long r0 = t * cpt;
    const int nr = static_cast<int>(min(static_cast<long long>(cpt), a.nc - r0));
    uint8_t* sExc = buf + PACKED_BYTES + BS;
    uint8_t* sAc = sExc + exc_stage_bytes(cpt, a.cape);
    const int ne = nr * a.cape / 16, na = nr * a.capc / 4;
    for (int i = tid; i < ne; i += TILE_B)
      tile::cp_async16(sExc + 16 * i, a.exc_rows + r0 * a.cape + 16 * i);
    for (int i = tid; i < na; i += TILE_B)
      tile::cp_async16(sAc + 16 * i, a.ac_rows + r0 * a.capc + 4 * i);
  }
  tile::cp_async_commit();
}

template <bool STAGED>
__device__ __forceinline__ void unpack_expand(const Args& a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, wid = tid >> 5;
  const long long tiles = (a.nblk + TILE_B - 1) / TILE_B;
  const int cpt = TILE_N / a.cw;
  const int bufb = buffer_bytes(STAGED, a.cw, a.cape, a.capc);
  const Walk wk(a.cw);
  const int m = wk.m;              // this lane's positions are 4m .. 4m+3
  const int sx = (m & 7) << 4;     // the swizzle of its rows 4m + j

  load_tile_async<STAGED>(smem, a, blockIdx.x, tid);
  int b = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, b ^= 1) {
    tile::cp_async_wait_all();
    __syncthreads();  // tile t landed; the other buffer's readers are done
    if (t + gridDim.x < tiles)
      load_tile_async<STAGED>(smem + (b ^ 1) * bufb, a, t + gridDim.x, tid);
    const uint8_t* sP = smem + b * bufb;
    const uint8_t* sExc = sP + PACKED_BYTES + BS;
    const float* sAc =
        reinterpret_cast<const float*>(sExc + exc_stage_bytes(cpt, a.cape));

    // widths of positions 4m .. 4m+3 (0 outside 1..4, as the plain unpack
    // reads them); markers 2^w - 1 (0xff at w = 0: no nibble reaches it)
    const unsigned wword =
        *reinterpret_cast<const unsigned*>(sP + PACKED_BYTES + 4 * m);
    int wd[4];
    unsigned mask[4], thrw = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = walk::byte_of(wword, j);
      wd[j] = w <= 4 ? w : 0;
      mask[j] = (1u << wd[j]) - 1u;
      thrw |= (wd[j] ? mask[j] : 0xffu) << (8 * j);
    }
    const uint8_t* prow = sP + 4 * m * ROW_BYTES;
    // this tile's rows, blocks and samples, in 32-bit offsets from here on
    const long long row0 = t * cpt;
    const int rows = static_cast<int>(min(a.nc - row0, static_cast<long long>(cpt)));
    const int blocks = static_cast<int>(min(a.nblk - t * TILE_B, static_cast<long long>(TILE_B)));
    const int stream = static_cast<int>(min(a.n_stream - t * TILE_N, static_cast<long long>(TILE_N)));
    const uint8_t* erows = STAGED ? sExc : a.exc_rows + row0 * a.cape;
    const float* arows = STAGED ? sAc : a.ac_rows + row0 * a.capc;
    uint8_t* ids_t = a.ids_out + t * TILE_N;
    float* acv_t = a.acv_out + t * TILE_N;

    for (int u = wid; u < wk.units; u += walk::WARPS) {
      int ecarry = 0, acarry = 0;
      for (int s = u * wk.steps; s < (u + 1) * wk.steps; ++s) {
        // the 8 values of row 4m+j at blocks 8s .. 8s+7: bits 8s*w ..
        // 8s*w + 8w of the row (the word after the row's last reads 0)
        unsigned f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bit = 8 * s * wd[j], wi = bit >> 5;
          const uint8_t* pr = prow + j * ROW_BYTES;
          const unsigned lo = *reinterpret_cast<const unsigned*>(pr + ((4 * wi) ^ sx));
          const unsigned hi = wi + 1 < ROW_BYTES / 4
              ? *reinterpret_cast<const unsigned*>(pr + ((4 * wi + 4) ^ sx)) : 0u;
          f[j] = __funnelshift_r(lo, hi, bit & 31);
        }
        unsigned nw[4], eb[4];
        int ce[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int kb = 2 * k + wk.half;
          unsigned w = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            w |= ((f[j] >> (kb * wd[j])) & mask[j]) << (8 * j);
          nw[k] = w;
          eb[k] = walk::zero_bytes_of(w ^ thrw);  // bit 7 of byte j: an exception
          ce[k] = __popc(eb[k]);
        }
        // exceptions take the next stored byte; the DC column reads ESCAPE
        const unsigned ci = pack4(ce[0], ce[1], ce[2], ce[3]);
        const unsigned cinc = wk.scan(ci);
        int ebase[4];
        ecarry = wk.bases(s, wk.total(ci), ecarry, ebase);
        unsigned idw[4], es[4];
        int ca[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r = wk.row(s, k);
          const uint8_t* erow = erows + r * a.cape;
          const int lim_e = r < rows ? a.cape : 0;  // ranks that read a byte
          int rank = ebase[k] + walk::byte_of(cinc - ci, k);
          unsigned w = nw[k];
          for (unsigned mk = eb[k]; mk; mk &= mk - 1, ++rank) {
            const int bsh = walk::low_byte_bit(mk);
            const unsigned id = rank < lim_e ? erow[rank] : 0u;
            w = (w & ~(0xffu << bsh)) | (id << bsh);
          }
          if (m == 0) w |= 0xffu;
          idw[k] = w;
          // escapes: off the DC column and below n_stream
          unsigned e = walk::ff_bytes_of(w) & (m == 0 ? 0x80808000u : walk::HI);
          const int lim = stream - (wk.block(s, k) * BS + 4 * m);
          if (lim < 4) e &= lim <= 0 ? 0u : (1u << (8 * lim)) - 1u;
          es[k] = e;
          ca[k] = __popc(e);
        }
        // escapes take the next stored AC value: a zero float4 per word,
        // then the value of each escape over it
        const unsigned ai = pack4(ca[0], ca[1], ca[2], ca[3]);
        const unsigned ainc = wk.scan(ai);
        int abase[4];
        acarry = wk.bases(s, wk.total(ai), acarry, abase);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int kb = wk.block(s, k);
          if (kb >= blocks) continue;
          const int r = wk.row(s, k);
          const float* arow = arows + r * a.capc;
          const int lim_a = r < rows ? a.capc : 0;
          const int o = kb * BS + 4 * m;
          *reinterpret_cast<unsigned*>(ids_t + o) = idw[k];
          *reinterpret_cast<float4*>(acv_t + o) = make_float4(0.f, 0.f, 0.f, 0.f);
          int rank = abase[k] + walk::byte_of(ainc - ai, k);
          for (unsigned mk = es[k]; mk; mk &= mk - 1, ++rank)
            acv_t[o + (walk::low_byte_bit(mk) >> 3)] = rank < lim_a ? arow[rank] : 0.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(TILE_B, MIN_CTAS)
    dpk_unpack_expand_kernel(const Args a) {
  unpack_expand<true>(a);
}

__global__ void __launch_bounds__(TILE_B, MIN_CTAS)
    dpk_unpack_expand_wide_kernel(const Args a) {
  unpack_expand<false>(a);
}

// CTAs of a persistent grid for a kernel whose dynamic shared memory
// depends on the call: the size is rounded up to whole KB and the grid is
// cached per device and size.
constexpr int SMEM_SLOTS = 64;  // KB of dynamic shared memory, at most

inline size_t round_kb(size_t bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

template <class Kernel>
long long persistent_grid_kb(Kernel kernel, size_t smem, long long tiles,
                             int (&cache)[SMEM_SLOTS][tile::MAX_DEVICES]) {
  const size_t kb = smem / 1024;
  if (kb >= SMEM_SLOTS) return 0;
  return tile::persistent_grid(kernel, smem, tiles, cache[kb]);
}

// The staged instantiation takes the call when the tile's chunk rows fit
// the budget and start on 16 bytes.
bool staged(const Args& a) {
  const int cpt = TILE_N / a.cw;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a.cape % 16 == 0 && a.capc % 4 == 0 && cpt * a.cape <= EXC_BUDGET &&
         cpt * a.capc * 4 <= AC_BUDGET && aligned(a.exc_rows) &&
         aligned(a.ac_rows);
}

size_t smem_bytes(bool st, int cw, int cape, int capc) {
  return round_kb(2 * static_cast<size_t>(buffer_bytes(st, cw, cape, capc)));
}

}  // namespace

extern "C" int dctz_dpk_unpack_expand(const uint8_t* width,
                                      const uint8_t* packed,
                                      const uint8_t* exc_rows,
                                      const float* ac_rows, long long nblk,
                                      long long nc, long long n_stream, int cw,
                                      int cape, int capc, uint8_t* ids,
                                      float* acv, void* stream) {
  static int cache_staged[SMEM_SLOTS][tile::MAX_DEVICES] = {};
  static int cache_wide[SMEM_SLOTS][tile::MAX_DEVICES] = {};
  const long long tiles = (nblk + TILE_B - 1) / TILE_B;
  if (tiles == 0) return 0;
  const Args a{width, packed, exc_rows, ac_rows, nblk, nc, n_stream,
               cw,    cape,   capc,     ids,     acv};
  const bool st = staged(a);
  const size_t smem = smem_bytes(st, cw, cape, capc);
  const auto kernel = st ? dpk_unpack_expand_kernel : dpk_unpack_expand_wide_kernel;
  const long long grid =
      persistent_grid_kb(kernel, smem, tiles, st ? cache_staged : cache_wide);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the buffers differ from call to call: allow this call's size (the
  // occupancy query above allowed the size it first met)
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<static_cast<unsigned>(grid), TILE_B, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM: the lesser of the two instantiations, the staged
// one at its largest buffers (cw = 512, both capacities 128).
extern "C" int dctz_ctas_per_sm_dpk_unpack_expand() {
  const int staged = tile::tile_ctas_per_sm(dpk_unpack_expand_kernel,
                                            smem_bytes(true, 512, 128, 128));
  const int wide = tile::tile_ctas_per_sm(dpk_unpack_expand_wide_kernel,
                                          smem_bytes(false, 512, 128, 128));
  return staged < wide ? staged : wide;
}
