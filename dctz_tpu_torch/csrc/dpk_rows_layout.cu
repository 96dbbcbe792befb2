// Kernel N dpk_rows_layout: a DPK container's tight row streams laid out as
// the zero-padded fixed-capacity rows that kernel C reads.
//
// It replaces no TPU kernel. The JAX package pads the rows on the host
// (dctz_tpu/api.py:_dpk_host_rebuild, entropy.pad_row_prefixes) and uploads
// the padded arrays; the port uploads the tight streams instead and lays the
// rows out here, in one launch for the three sections of a container:
//
//   packed ids  tight bytes -> (rows, tile_b / 2) u8
//   exceptions  tight bytes -> (nc, cape) u8
//   AC values   four tight byte planes of 4-byte items -> (nc, capc) 32-bit
//               words, item = p0 | p1 << 8 | p2 << 16 | p3 << 24 (the
//               planes of entropy.decode_float_planes, so C takes the float32
//               rows directly); or, for any other stored item, tight bytes
//               -> (nc, capc * itemsize) u8
//
// Each section comes with int64 prefix offsets (rows + 1 of them, in items)
// of its rows in the tight stream; row r holds off[r + 1] - off[r] items,
// then zeros up to the capacity. The host has checked every length against
// the capacity and off[rows] against the stream's size.
//
// Bound by bytes: it reads each tight byte once and writes each padded byte
// once, with no arithmetic to speak of. One thread makes one 16-byte unit of
// the output (16 bytes, or 4 words of the AC planes), so a warp stores 512
// contiguous bytes with 16-byte vector stores, each a whole sector, and the
// outputs (fresh allocations) start on 256 bytes. The loads follow the same
// order: neighbouring threads read neighbouring 16-byte spans of the tight
// stream, as aligned 32-bit words (five, or two a plane) joined with funnel
// shifts, since a row's data starts on any byte. A unit past its row's data
// stores zeros without a load. Units that straddle a row end, or whose words
// would reach past the stream's end, take a byte-by-byte path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Seg {
  const uint8_t* src;    // tight stream (plane 0 for planes)
  const long long* off;  // rows + 1 prefix offsets of the rows, in items
  uint8_t* dst;          // rows * cap items, zero-padded rows
  long long rows;
  long long plane;       // bytes from one plane to the next (planes)
  long long units;       // 16-byte units of dst
  int cap;               // items a row
  int planes;            // 1: bytes; 4: four byte planes -> 32-bit words
};

struct Args {
  Seg s[3];
  long long units;  // the three sections' units together
};

// Four little-endian words of the 16 bytes at p, read as aligned 32-bit words
// when they lie below `end`, else byte by byte. The stream starts on 4 bytes.
__device__ __forceinline__ uint4 load16(const uint8_t* p, const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
  if (reinterpret_cast<const uint8_t*>(w + 5) <= end) {
    const unsigned sh = 8u * static_cast<unsigned>(a & 3);
    const unsigned x0 = __ldg(w), x1 = __ldg(w + 1), x2 = __ldg(w + 2),
                   x3 = __ldg(w + 3), x4 = __ldg(w + 4);
    return make_uint4(__funnelshift_r(x0, x1, sh), __funnelshift_r(x1, x2, sh),
                      __funnelshift_r(x2, x3, sh), __funnelshift_r(x3, x4, sh));
  }
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i >> 2] |= static_cast<unsigned>(__ldg(p + i)) << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The 4 bytes at p as one little-endian word (see load16). A plane past the
// first need not start on 4 bytes: its first word may begin in the plane
// before it, which lies in the same stream.
__device__ __forceinline__ unsigned load4(const uint8_t* p, const uint8_t* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~uintptr_t(3));
  if (reinterpret_cast<const uint8_t*>(w + 2) <= end)
    return __funnelshift_r(__ldg(w), __ldg(w + 1), 8u * static_cast<unsigned>(a & 3));
  unsigned v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) v |= static_cast<unsigned>(__ldg(p + i)) << (8 * i);
  return v;
}

// Item j of a section's grid: byte j, or the word of the four planes' bytes.
__device__ __forceinline__ unsigned item_at(const Seg& s, long long j) {
  const long long r = j / s.cap;
  const long long c = j - r * s.cap;
  const long long st = s.off[r];
  if (c >= s.off[r + 1] - st) return 0u;
  if (s.planes == 1) return __ldg(s.src + st + c);
  unsigned v = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v |= static_cast<unsigned>(__ldg(s.src + k * s.plane + st + c)) << (8 * k);
  return v;
}

// Unit v of a byte section: dst bytes 16v .. 16v + 15.
__device__ __forceinline__ void bytes_unit(const Seg& s, long long v) {
  const long long p = 16 * v;
  const long long total = s.rows * s.cap;
  const long long r = p / s.cap;
  const int c = static_cast<int>(p - r * s.cap);
  if (p + 16 <= total && c + 16 <= s.cap) {
    const long long st = s.off[r];
    const long long len = s.off[r + 1] - st;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (c + 16 <= len) {
      w = load16(s.src + st + c, s.src + s.off[s.rows]);
    } else if (c < len) {
      unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (c + i < len) b[i >> 2] |= static_cast<unsigned>(__ldg(s.src + st + c + i)) << (8 * (i & 3));
      w = make_uint4(b[0], b[1], b[2], b[3]);
    }
    *reinterpret_cast<uint4*>(s.dst + p) = w;
    return;
  }
  for (long long j = p; j < p + 16 && j < total; ++j) s.dst[j] = static_cast<uint8_t>(item_at(s, j));
}

// Unit v of a planes section: dst words 4v .. 4v + 3.
__device__ __forceinline__ void planes_unit(const Seg& s, long long v) {
  const long long q = 4 * v;
  const long long total = s.rows * s.cap;
  const long long r = q / s.cap;
  const int c = static_cast<int>(q - r * s.cap);
  unsigned* dst = reinterpret_cast<unsigned*>(s.dst);
  if (q + 4 <= total && c + 4 <= s.cap) {
    const long long st = s.off[r];
    const long long len = s.off[r + 1] - st;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (c + 4 <= len) {
      const long long n = s.off[s.rows];
      unsigned b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint8_t* pk = s.src + k * s.plane;
        b[k] = load4(pk + st + c, pk + n);
      }
      // byte i of plane k -> byte k of item i
      const unsigned lo01 = __byte_perm(b[0], b[1], 0x5140), lo23 = __byte_perm(b[2], b[3], 0x5140);
      const unsigned hi01 = __byte_perm(b[0], b[1], 0x7362), hi23 = __byte_perm(b[2], b[3], 0x7362);
      w = make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    } else if (c < len) {
      unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c + i < len) b[i] = item_at(s, q + i);
      w = make_uint4(b[0], b[1], b[2], b[3]);
    }
    *reinterpret_cast<uint4*>(dst + q) = w;
    return;
  }
  for (long long j = q; j < q + 4 && j < total; ++j) dst[j] = item_at(s, j);
}

__global__ void __launch_bounds__(THREADS) dpk_rows_layout_kernel(const Args a) {
  // each section by its own constant index, so that its fields are read
  // from the parameter space (a run-time index would copy them to local
  // memory); only the AC section can hold planes
  long long v = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (v >= a.units) return;
  if (v < a.s[0].units) {
    bytes_unit(a.s[0], v);
    return;
  }
  v -= a.s[0].units;
  if (v < a.s[1].units) {
    bytes_unit(a.s[1], v);
    return;
  }
  v -= a.s[1].units;
  if (a.s[2].planes == 4)
    planes_unit(a.s[2], v);
  else
    bytes_unit(a.s[2], v);
}

Seg seg_of(const uint8_t* src, const long long* off, long long rows, int cap,
           int planes, long long plane, uint8_t* dst) {
  const long long bytes = rows * cap * (planes == 4 ? 4 : 1);
  return Seg{src, off, dst, rows, plane, (bytes + 15) / 16, cap, planes};
}

}  // namespace

// packed, exc: tight bytes; ac: plane 0 of four planes `ac_plane` bytes apart
// (ac_planes 4), or tight bytes (ac_planes 1); packed, exc and ac start on 4
// bytes; *_off the rows' int64 prefix offsets, in items; *_cap items a row;
// a section of no rows is skipped.
extern "C" int dctz_dpk_rows_layout(
    const uint8_t* packed, const long long* packed_off, long long packed_rows,
    int packed_cap, uint8_t* packed_out, const uint8_t* exc,
    const long long* exc_off, long long exc_rows, int exc_cap, uint8_t* exc_out,
    const uint8_t* ac, long long ac_plane, const long long* ac_off,
    long long ac_rows, int ac_cap, int ac_planes, uint8_t* ac_out, void* stream) {
  if ((ac_planes != 1 && ac_planes != 4) || packed_rows < 0 || exc_rows < 0 ||
      ac_rows < 0 || (packed_rows && packed_cap < 1) || (exc_rows && exc_cap < 1) ||
      (ac_rows && ac_cap < 1) ||
      (reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(exc) |
       reinterpret_cast<uintptr_t>(ac)) & 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{{seg_of(packed, packed_off, packed_rows, packed_cap, 1, 0, packed_out),
          seg_of(exc, exc_off, exc_rows, exc_cap, 1, 0, exc_out),
          seg_of(ac, ac_off, ac_rows, ac_cap, ac_planes, ac_plane, ac_out)},
         0};
  a.units = a.s[0].units + a.s[1].units + a.s[2].units;
  if (a.units == 0) return static_cast<int>(cudaSuccess);
  const long long grid = (a.units + THREADS - 1) / THREADS;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  dpk_rows_layout_kernel<<<static_cast<unsigned>(grid), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dctz_ctas_per_sm_dpk_rows_layout() {
  return dctz::ctas_per_sm(dpk_rows_layout_kernel, THREADS, 0);
}
