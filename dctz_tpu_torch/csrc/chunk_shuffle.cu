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
// over. Two walks rank the masked samples here:
//
// The lane walk (I, and the second instantiations of H, J and K,
// chunk_compact_lanes, chunk_compact_unified_lanes and
// chunk_compact_bytes_lanes): one warp walks one
// chunk row 32 samples at a time, one mask byte a lane; __ballot_sync marks
// the masked lanes, __popc of the lanes below gives each one its rank, and a
// running count carries the rank across steps. J ranks the exceptions and
// the escapes among them in the same walk, with two ballots a step. Any cw
// that is a multiple of 32 works (the TPU kernels need cw % 128 == 0).
//
// The word walk (H chunk_compact, J chunk_compact_unified and K
// chunk_compact_bytes, for cw = 64, 128, 256 or a multiple of 512, 16-byte
// aligned mask and id bytes, and rows whose staging fits, words::takes): a
// warp step covers 512 samples, lane l holding samples 16l .. 16l+15 as one
// 16-byte word (J and K: and their id bytes, another). K is J's exception
// half alone: one template, compact_exceptions<AC>, compiles both, K with
// the AC values compiled out. Byte tests in 32-bit words count a word's
// masked bytes (and, where they are needed, turn it into 16 flags). A
// lane's first rank comes from an inclusive shuffle scan over the lanes of
// each chunk row (16, 8 or 4 lanes at cw = 256, 128, 64; the warp from 512,
// where the warp carries the count across a row's cw/512 steps; J scans the
// exception and escape counts packed in one word). H takes one ballot in
// its place where no lane of the warp holds two masked samples, the common
// case on its escape masks; on the exception masks of J and K some lane of
// nearly every step holds two, and the test alone made them slower. A lane
// then gathers only its kept values and writes them by rank into its row of
// a zeroed staging copy in shared memory of the CTA's group of rows; after
// one barrier the CTA stores the group's contiguous span of rows with
// 16-byte streaming stores (the ends, which need not start on 16 bytes when
// capc * 4 is not a multiple of 16, element by element) and zeroes the
// staging as it reads it. A group is two steps per warp up to cw = 512 (16
// rows at 512), a row per warp above. CTAs are persistent (SMs x resident
// CTAs, walking groups blockIdx.x, + gridDim.x, ...), with two staging
// buffers and one barrier per group; each warp keeps the words of its next
// two steps in flight (streaming loads into registers). J and K load every
// id word: an id load that waits for its mask word was no faster
// (kernels/stage_split.py times that and K's other alternatives).
//
// What bounds them: bytes, with no arithmetic to speak of. Each kernel reads
// the mask, 1 byte per sample, and a value only where it keeps one: H and K
// the first capc masked values of a row, I one row slot per masked position,
// J the id bytes too and the AC values it keeps. H, J and K write their
// rows, I 4 bytes per sample. The word walks of J and K read every id word,
// a second byte per sample, which sets their floor above that bound (K at
// 32Mi samples reads 67 MB where the bound counts the 33.5 MB mask and the
// kept bytes), and their walks (the scan, a shared byte store per
// exception) cost about as much again: K without its id words is only a
// few percent faster.

#include "dpk_walk.cuh"

namespace {

using namespace dctz;

constexpr int WARPS = 8;  // lane walk: chunk rows per CUDA block, one warp each

struct CompactArgs {
  const uint8_t* mask;
  const float* vals;
  long long nc;
  int cw, capc;
  float* rows;
  int* counts;
  int buf;  // word walk: bytes of one staging buffer
};

struct UnifiedArgs {
  const uint8_t* mask;
  const uint8_t* idb;
  const float* vals;
  long long nc;
  int cw, cape, capc, cut;
  uint8_t* exc;
  float* ac;
  int buf, ebytes;  // word walk: bytes of one staging buffer, of its exc rows
};

// The stable compaction of one chunk row by its warp (the lane walks of
// kernels H and K); counts may be null.
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
    chunk_compact_lanes_kernel(const CompactArgs a) {
  compact_row(a.mask, a.vals, a.nc, a.cw, a.capc, a.rows, a.counts);
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_bytes_lanes_kernel(const uint8_t* __restrict__ mask,
                                     const uint8_t* __restrict__ vals, long long nc,
                                     int cw, int capc, uint8_t* __restrict__ rows) {
  compact_row(mask, vals, nc, cw, capc, rows, static_cast<int*>(nullptr));
}

__global__ void __launch_bounds__(WARPS * 32)
    chunk_compact_unified_lanes_kernel(const UnifiedArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= a.nc) return;
  const uint8_t* m = a.mask + row * a.cw;
  const uint8_t* ib = a.idb + row * a.cw;
  const float* v = a.vals + row * a.cw;
  uint8_t* eo = a.exc + row * a.cape;
  float* ao = a.ac + row * a.capc;
  const unsigned below = lanes_below();
  const int need = max(a.cape, a.cut);  // exception ranks whose id byte is used
  int ecount = 0, acount = 0;
  for (int e0 = 0; e0 < a.cw; e0 += 32) {
    const int e = e0 + lane;
    const bool on = m[e] != 0;
    const unsigned bm = __ballot_sync(FULL, on);
    const int rank = ecount + __popc(bm & below);
    const int id = (on && rank < need) ? ib[e] : 0;
    if (on && rank < a.cape) eo[rank] = static_cast<uint8_t>(id);
    const bool esc = on && id == ESCAPE && rank < a.cut;
    const unsigned ba = __ballot_sync(FULL, esc);
    const int arank = acount + __popc(ba & below);
    if (esc && arank < a.capc) ao[arank] = v[e];
    ecount += __popc(bm);
    acount += __popc(ba);
  }
  for (int q = min(ecount, a.cape) + lane; q < a.cape; q += 32) eo[q] = 0;
  for (int q = min(acount, a.capc) + lane; q < a.capc; q += 32) ao[q] = 0.f;
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

// ---------------------------------------------------------------------------
// The word walk of H, J and K
// ---------------------------------------------------------------------------

namespace words {

constexpr int THREADS = tile::THREADS;  // 256
constexpr int NW = THREADS / 32;        // warps per CTA
constexpr int STEP = 512;               // samples per warp step
constexpr int STAGE_MAX = 96 * 1024;    // bytes of a group's staged rows, at most
// chunk rows of a call, fewer than (a mask of 64 GB and more is refused;
// the cursors' int rows run up to two steps of the grid past the last row)
constexpr long long ROWS_MAX = 1LL << 30;

// Chunk rows of a group: two steps per warp below cw = 1024, else a row per
// warp.
__host__ __device__ __forceinline__ int group_rows(int cw) {
  return cw <= STEP ? NW * (2 * STEP / cw) : NW;
}

// Bytes of one output's region in a staging buffer: its rows, and 16 more so
// that the span may start at any offset from 16 bytes.
__host__ __device__ __forceinline__ int region(int rows, long long row_bytes) {
  return static_cast<int>((rows * row_bytes + 15) / 16 * 16 + 16);
}

// Does the word walk take a call: cw = 64, 128, 256 or a multiple of 512,
// 16-byte aligned byte inputs, and a group's rows of row_bytes within
// STAGE_MAX (ops/shuffle.py:walk_of is the same rule).
template <class... Ptr>
bool takes(int cw, long long row_bytes, Ptr... ptrs) {
  const bool shape = cw == 64 || cw == 128 || cw == 256 || (cw > 0 && cw % STEP == 0);
  const bool aligned = ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
  return shape && aligned && group_rows(cw) * row_bytes <= STAGE_MAX;
}

// This lane's place in the walk of chunk width cw. A warp's part of a group
// is Q steps over a contiguous span of Q * 512 samples, RW whole rows,
// walked in order; lane l holds samples 16l .. 16l+15 of each step.
struct Geo {
  int width;          // lanes of a chunk row in a step: cw/16 below 512, else 32
  int Q;              // steps per warp and group: 2 up to cw = 512, else cw/512
  int RW;             // chunk rows per warp and group
  int R;              // chunk rows per group
  int rstep;          // chunk rows per step below 1024 (512/cw), else 0
  int seg;            // this lane's chunk row within its step
  int gl;             // this lane's index among its row's lanes
  unsigned segmask;   // the lanes of this lane's row within a step

  __device__ __forceinline__ explicit Geo(int cw) {
    const int lane = threadIdx.x & 31;
    width = cw < STEP ? cw / 16 : 32;
    Q = cw <= STEP ? 2 : cw / STEP;
    RW = cw <= STEP ? 2 * STEP / cw : 1;
    R = NW * RW;
    rstep = cw <= STEP ? STEP / cw : 0;
    seg = lane >> (__ffs(width) - 1);
    gl = lane & (width - 1);
    segmask = width == 32 ? FULL : ((1u << width) - 1u) << (seg * width);
  }
  // does step j start / end a chunk row
  __device__ __forceinline__ bool starts(int j) const { return rstep != 0 || j == 0; }
  __device__ __forceinline__ bool ends(int j) const { return rstep != 0 || j == Q - 1; }
  // inclusive sum of v over the row's lanes up to this one
  __device__ __forceinline__ unsigned scan(unsigned v) const {
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d >= width) break;
      const unsigned t = __shfl_up_sync(FULL, v, d, width);
      if (gl >= d) v += t;
    }
    return v;
  }
  // the row's sum, from the inclusive scan, in every lane of the row
  __device__ __forceinline__ unsigned total(unsigned inc) const {
    return __shfl_sync(FULL, inc, width - 1, width);
  }
};

// The steps a warp walks, in order (step j of its part of group g, for g =
// blockIdx.x, + gridDim.x, ...), with this lane's byte offset in the (nc, cw)
// inputs and its chunk row, kept up to date by additions. Rows and groups
// are ints: the host refuses ROWS_MAX rows and more.
struct Cursor {
  int g, j, row;
  long long off;
  __device__ __forceinline__ Cursor(const Geo& q, int cw, int wid) {
    g = blockIdx.x;
    j = 0;
    row = g * q.R + wid * q.RW + q.seg;
    off = static_cast<long long>(g * q.R + wid * q.RW) * cw + (threadIdx.x & 31) * 16;
  }
  __device__ __forceinline__ void next(const Geo& q, int cw) {
    row += q.rstep;
    off += STEP;
    if (++j == q.Q) {
      j = 0;
      g += gridDim.x;
      row += static_cast<int>(gridDim.x) * q.R - q.Q * q.rstep;
      off += static_cast<long long>(gridDim.x) * q.R * cw - q.Q * STEP;
    }
  }
  __device__ __forceinline__ bool valid(int groups, int nc) const {
    return g < groups && row < nc;
  }
};

// The 16 bytes at p (streamed: read once), or zeros.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// Bit 7 of each byte of h (its other bits 0) -> bits 0..3; the partial
// products of the multiply fall on distinct bits, so nothing carries.
__device__ __forceinline__ unsigned flags4(unsigned h) {
  return (((h >> 7) * 0x204081u) >> 21) & 0xfu;
}
// bit 7 of each byte of x that is not 0
__device__ __forceinline__ unsigned nonzero_bytes_of(unsigned x) {
  return (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & walk::HI;
}
// bytes of the word that are not 0
__device__ __forceinline__ int count16(uint4 w) {
  return __popc(nonzero_bytes_of(w.x) >> 7 | nonzero_bytes_of(w.y) >> 6 |
                nonzero_bytes_of(w.z) >> 5 | nonzero_bytes_of(w.w) >> 4);
}
// bit j set where byte j of the word is not 0
__device__ __forceinline__ unsigned nonzero16(uint4 w) {
  return flags4(nonzero_bytes_of(w.x)) | flags4(nonzero_bytes_of(w.y)) << 4 |
         flags4(nonzero_bytes_of(w.z)) << 8 | flags4(nonzero_bytes_of(w.w)) << 12;
}
// bit j set where byte j of the word is 0xff (ESCAPE)
__device__ __forceinline__ unsigned escape16(uint4 w) {
  return flags4(walk::ff_bytes_of(w.x)) | flags4(walk::ff_bytes_of(w.y)) << 4 |
         flags4(walk::ff_bytes_of(w.z)) << 8 | flags4(walk::ff_bytes_of(w.w)) << 12;
}
// byte b of the word
__device__ __forceinline__ unsigned byte16(uint4 w, int b) {
  const unsigned x = b < 8 ? (b < 4 ? w.x : w.y) : (b < 12 ? w.z : w.w);
  return (x >> (8 * (b & 3))) & 0xffu;
}

// Elements of p's offset from 16 bytes.
template <class T>
__device__ __forceinline__ int pad_of(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Store the staged span of len elements, element m at st[pad + m] with pad =
// pad_of(dst), to dst, and zero it in shared memory: the aligned middle in
// 16-byte streaming stores, the ends element by element.
template <class T>
__device__ __forceinline__ void store_span(T* st, int pad, T* __restrict__ dst,
                                           int len, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int head = min((V - pad) & (V - 1), len);
  const int nv = (len - head) / V;
  const int tail = len - head - nv * V;
  uint4* s4 = reinterpret_cast<uint4*>(st + pad + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = tid; i < nv; i += THREADS) {
    __stcs(d4 + i, s4[i]);
    s4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid < head) {
    dst[tid] = st[pad + tid];
    st[pad + tid] = T(0);
  } else if (tid >= V && tid < V + tail) {
    const int m = head + nv * V + tid - V;
    dst[m] = st[pad + m];
    st[pad + m] = T(0);
  }
}

__device__ __forceinline__ void zero_shared(unsigned char* smem, int bytes, int tid) {
  uint4* s = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < bytes / 16; i += THREADS) s[i] = make_uint4(0u, 0u, 0u, 0u);
}

}  // namespace words

__global__ void __launch_bounds__(words::THREADS, 3)
    chunk_compact_kernel(const CompactArgs a) {
  using namespace words;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, wid = tid >> 5;
  const Geo q(a.cw);
  const int nc = static_cast<int>(a.nc);
  const int groups = (nc + q.R - 1) / q.R;
  const unsigned below = lanes_below();
  zero_shared(smem, 2 * a.buf, tid);
  __syncthreads();
  // the mask words of the warp's next two steps, in flight
  Cursor ld(q, a.cw, wid);
  const auto fetch = [&]() {
    const uint4 w = load16(a.mask + ld.off, ld.valid(groups, nc));
    ld.next(q, a.cw);
    return w;
  };
  uint4 w0 = fetch();
  uint4 w1 = fetch();
  int carry = 0;
  int half = 0;  // byte offset of this group's staging buffer: 0 or a.buf
  for (int g = blockIdx.x; g < groups; g += gridDim.x, half ^= a.buf) {
    float* st = reinterpret_cast<float*>(smem + half);
    const int r0 = g * q.R;
    float* dst = a.rows + static_cast<long long>(r0) * a.capc;
    const int pad = pad_of(dst);
    const int wrow = wid * q.RW + q.seg;  // this lane's row of step 0 in the group
    const float* vw = a.vals + static_cast<long long>(r0 + wid * q.RW) * a.cw + (tid & 31) * 16;
    for (int j = 0; j < q.Q; ++j) {
      const uint4 cur = w0;
      w0 = w1;
      w1 = fetch();
      const int srow_i = wrow + j * q.rstep;  // this lane's row in the group
      const int c = count16(cur);
      // ranks: where no lane holds two masked samples (the common case on the
      // codec's masks), a ballot; else a shuffle scan over the row's lanes
      int before, tot;
      if (__any_sync(FULL, c > 1)) {
        const int inc = static_cast<int>(q.scan(c));
        before = inc - c;
        tot = static_cast<int>(q.total(inc));
      } else {
        const unsigned b = __ballot_sync(FULL, c != 0) & q.segmask;
        before = __popc(b & below);
        tot = __popc(b);
      }
      if (q.starts(j)) carry = 0;
      int r = carry + before;
      if (c != 0 && r < a.capc) {
        // the kept values, by rank, into the staged row
        float* srow = st + pad + srow_i * a.capc;
        const float* v = vw + j * STEP;
        for (unsigned m = nonzero16(cur); m != 0 && r < a.capc; m &= m - 1, ++r)
          srow[r] = v[__ffs(m) - 1];
      }
      carry += tot;
      if (q.ends(j) && q.gl == 0 && r0 + srow_i < nc) a.counts[r0 + srow_i] = carry;
    }
    __syncthreads();
    const int rows = min(q.R, nc - r0);
    store_span(st, pad, dst, rows * a.capc, tid);
  }
}

// The exception walk of J (AC: the masked id bytes and, in the same walk,
// the AC values of the escapes among them) and of K (!AC: the masked bytes
// alone, from a.idb into a.exc; a.vals, a.ac, a.capc and a.cut unused).
template <bool AC>
__device__ __forceinline__ void compact_exceptions(const UnifiedArgs& a) {
  using namespace words;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, wid = tid >> 5;
  const Geo q(a.cw);
  const int nc = static_cast<int>(a.nc);
  const int groups = (nc + q.R - 1) / q.R;
  // exception ranks whose id byte is used
  const int need = AC ? max(a.cape, a.cut) : a.cape;
  zero_shared(smem, 2 * a.buf, tid);
  __syncthreads();
  // the mask and id words of the warp's next two steps, in flight
  Cursor ld(q, a.cw, wid);
  const auto fetch = [&](uint4& m, uint4& i) {
    const bool ok = ld.valid(groups, nc);
    m = load16(a.mask + ld.off, ok);
    i = load16(a.idb + ld.off, ok);
    ld.next(q, a.cw);
  };
  uint4 m0, i0, m1, i1;
  fetch(m0, i0);
  fetch(m1, i1);
  int ecarry = 0, acarry = 0;
  int half = 0;  // byte offset of this group's staging buffer: 0 or a.buf
  for (int g = blockIdx.x; g < groups; g += gridDim.x, half ^= a.buf) {
    uint8_t* se = smem + half;
    float* sa = reinterpret_cast<float*>(se + a.ebytes);
    const int r0 = g * q.R;
    uint8_t* edst = a.exc + static_cast<long long>(r0) * a.cape;
    float* adst = AC ? a.ac + static_cast<long long>(r0) * a.capc : nullptr;
    const int pe = pad_of(edst), pa = AC ? pad_of(adst) : 0;
    const int wrow = wid * q.RW + q.seg;
    const float* vw = AC ? a.vals + static_cast<long long>(r0 + wid * q.RW) * a.cw + (tid & 31) * 16
                         : nullptr;
    for (int j = 0; j < q.Q; ++j) {
      const uint4 cur = m0, idw = i0;
      m0 = m1;
      i0 = i1;
      fetch(m1, i1);
      const int srow_i = wrow + j * q.rstep;
      // this lane's exceptions, and the escapes among them
      const unsigned mb = nonzero16(cur);
      const unsigned eb = AC ? escape16(idw) & mb : 0u;
      const int c = __popc(mb), na = __popc(eb);
      // exception counts in the low half, escape counts in the high half
      const unsigned inc = q.scan(static_cast<unsigned>(c | na << 16));
      const int before_e = static_cast<int>(inc & 0xffffu) - c;
      const int before_a = static_cast<int>(inc >> 16) - na;
      const int tot_e = static_cast<int>(q.total(inc) & 0xffffu);
      if (q.starts(j)) ecarry = acarry = 0;
      // ranks: the exception rank of this lane's first masked sample, and the
      // escape rank of its first escape (exact wherever the exception rank is
      // below the cut: every earlier escape of the row is kept then)
      int r = ecarry + before_e;
      int ar = acarry + before_a;
      uint8_t* erow = se + pe + srow_i * a.cape;
      float* arow = sa + pa + srow_i * a.capc;
      const float* v = AC ? vw + j * STEP : nullptr;
      int kept = 0;
      for (unsigned m = mb; m != 0 && r < need; m &= m - 1, ++r) {
        const int b = __ffs(m) - 1;
        const unsigned id = byte16(idw, b);
        if (r < a.cape) erow[r] = static_cast<uint8_t>(id);
        if (AC && id == ESCAPE && r < a.cut) {
          if (ar < a.capc) arow[ar] = v[b];
          ++ar;
          ++kept;
        }
      }
      ecarry += tot_e;
      if (AC && q.rstep == 0) acarry += __reduce_add_sync(FULL, kept);
    }
    __syncthreads();
    const int rows = min(q.R, nc - r0);
    store_span(se, pe, edst, rows * a.cape, tid);
    if (AC) store_span(sa, pa, adst, rows * a.capc, tid);
  }
}

__global__ void __launch_bounds__(words::THREADS, 3)
    chunk_compact_unified_kernel(const UnifiedArgs a) {
  compact_exceptions<true>(a);
}

__global__ void __launch_bounds__(words::THREADS, 3)
    chunk_compact_bytes_kernel(const UnifiedArgs a) {
  compact_exceptions<false>(a);
}

// CTAs of a persistent grid for a kernel whose dynamic shared memory
// depends on the call: the size is whole KB, and the grid is cached per
// device and size.
constexpr int SMEM_SLOTS = 200;  // KB of dynamic shared memory, at most

size_t round_kb(size_t bytes) { return (bytes + 1023) / 1024 * 1024; }

template <class Kernel>
long long persistent_grid_kb(Kernel kernel, size_t smem, long long groups,
                             int (&cache)[SMEM_SLOTS][tile::MAX_DEVICES]) {
  const size_t kb = smem / 1024;
  if (kb >= SMEM_SLOTS) return 0;
  return tile::persistent_grid(kernel, smem, groups, cache[kb]);
}

// Dynamic shared memory of the word walks: two staging buffers.
size_t compact_smem(int cw, int capc, int* buf) {
  *buf = words::region(words::group_rows(cw), 4LL * capc);
  return round_kb(2 * static_cast<size_t>(*buf));
}

// J's exception and AC rows; K's exception rows alone (capc 0).
size_t unified_smem(int cw, int cape, int capc, int* buf, int* ebytes) {
  const int rows = words::group_rows(cw);
  *ebytes = words::region(rows, cape);
  *buf = *ebytes + (capc > 0 ? words::region(rows, 4LL * capc) : 0);
  return round_kb(2 * static_cast<size_t>(*buf));
}

// Launch a word-walk kernel on its persistent grid, allowing its dynamic
// shared memory first.
template <class Kernel, class Args>
int launch_words(Kernel kernel, const Args& a, size_t smem, long long groups,
                 int (&cache)[SMEM_SLOTS][tile::MAX_DEVICES], void* stream) {
  const long long grid = persistent_grid_kb(kernel, smem, groups, cache);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  kernel<<<static_cast<unsigned>(grid), words::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `word_walk`: 1 for the word walk (which must take the call,
// words::takes), 0 for the lane walk; ops/shuffle.py:walk_of chooses.
extern "C" int dctz_chunk_compact(const uint8_t* mask, const float* vals,
                                  long long nc, int cw, int capc, float* rows,
                                  int* counts, int word_walk, void* stream) {
  CompactArgs a{mask, vals, nc, cw, capc, rows, counts, 0};
  if (!word_walk) {
    chunk_compact_lanes_kernel<<<grid_of(nc), WARPS * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (!words::takes(cw, 4LL * capc, mask) || capc < 1 || nc >= words::ROWS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static int cache[SMEM_SLOTS][tile::MAX_DEVICES] = {};
  const size_t smem = compact_smem(cw, capc, &a.buf);
  const int r = words::group_rows(cw);
  return launch_words(chunk_compact_kernel, a, smem, (nc + r - 1) / r, cache, stream);
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
                                        uint8_t* rows, int word_walk, void* stream) {
  if (!word_walk) {
    chunk_compact_bytes_lanes_kernel<<<grid_of(nc), WARPS * 32, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        mask, vals, nc, cw, capc, rows);
    return static_cast<int>(cudaGetLastError());
  }
  if (!words::takes(cw, capc, mask, vals) || capc < 1 || nc >= words::ROWS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // J's exception half: the bytes in place of the id bytes, no AC rows
  UnifiedArgs a{mask, vals, nullptr, nc, cw, capc, 0, capc, rows, nullptr, 0, 0};
  static int cache[SMEM_SLOTS][tile::MAX_DEVICES] = {};
  const size_t smem = unified_smem(cw, capc, 0, &a.buf, &a.ebytes);
  const int r = words::group_rows(cw);
  return launch_words(chunk_compact_bytes_kernel, a, smem, (nc + r - 1) / r, cache, stream);
}

extern "C" int dctz_chunk_compact_unified(const uint8_t* mask,
                                          const uint8_t* idb, const float* vals,
                                          long long nc, int cw, int cape,
                                          int capc, int cut, uint8_t* exc,
                                          float* ac, int word_walk, void* stream) {
  UnifiedArgs a{mask, idb, vals, nc, cw, cape, capc, cut, exc, ac, 0, 0};
  if (!word_walk) {
    chunk_compact_unified_lanes_kernel<<<grid_of(nc), WARPS * 32, 0,
                                         static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (!words::takes(cw, cape + 4LL * capc, mask, idb) || cape < 1 || capc < 1 ||
      nc >= words::ROWS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static int cache[SMEM_SLOTS][tile::MAX_DEVICES] = {};
  const size_t smem = unified_smem(cw, cape, capc, &a.buf, &a.ebytes);
  const int r = words::group_rows(cw);
  return launch_words(chunk_compact_unified_kernel, a, smem, (nc + r - 1) / r, cache,
                      stream);
}

// Resident CTAs per SM at the launch configuration; the word walks at their
// largest buffers on the API's paths (cw = 512, every capacity 512: H's
// overflow retry; K at the same width and capacity).
extern "C" int dctz_ctas_per_sm_chunk_compact() {
  int buf = 0;
  return tile::tile_ctas_per_sm(chunk_compact_kernel, compact_smem(512, 512, &buf));
}
extern "C" int dctz_ctas_per_sm_chunk_compact_lanes() { return dctz::ctas_per_sm(chunk_compact_lanes_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_expand() { return dctz::ctas_per_sm(chunk_expand_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_compact_unified() {
  int buf = 0, ebytes = 0;
  return tile::tile_ctas_per_sm(chunk_compact_unified_kernel,
                                unified_smem(512, 512, 512, &buf, &ebytes));
}
extern "C" int dctz_ctas_per_sm_chunk_compact_unified_lanes() { return dctz::ctas_per_sm(chunk_compact_unified_lanes_kernel, WARPS * 32, 0); }
extern "C" int dctz_ctas_per_sm_chunk_compact_bytes() {
  int buf = 0, ebytes = 0;
  return tile::tile_ctas_per_sm(chunk_compact_bytes_kernel,
                                unified_smem(512, 512, 0, &buf, &ebytes));
}
extern "C" int dctz_ctas_per_sm_chunk_compact_bytes_lanes() { return dctz::ctas_per_sm(chunk_compact_bytes_lanes_kernel, WARPS * 32, 0); }
