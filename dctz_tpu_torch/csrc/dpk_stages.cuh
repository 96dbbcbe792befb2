// The word-wide DPK tile stages of kernels B (dpk_pack_compact.cu) and L
// (fused_encode_dpk.cu), on a tile of 256 DCT blocks whose ids a CTA of 256
// threads holds in shared memory as loaded (block rows of 64 bytes):
// - nibbles_and_counts: a thread takes 8 blocks x 4 positions (8 words of
//   ids), clamps them to 15 and counts the four thresholds 4 nibbles at a
//   time (exact byte tests, byte-wise sums reduced by a shuffle and one
//   shared table), and transposes them with __byte_perm into a
//   position-major copy of 4-bit nibbles (word q of row p: blocks 8q ..
//   8q+7), written and read in words;
// - select_widths: the width per position, cost w*256 + 8*#(nib >= 2^w - 1),
//   first minimum;
// - pack_tile: a thread turns a row's 64 nibbles (8 words) into 8w bytes
//   (the w = 4 row is the nibble copy itself; w = 1, 2, 3 clamp and gather
//   bits in registers) and writes them and its share of the row's zero tail
//   with 8- and 16-byte stores;
// - walk_exceptions: the chunk-row walk (dpk_walk.cuh) of the exception
//   bytes (nib >= 2^w - 1) into cape slots with the true counts; KEEP also
//   stores the AC escapes among the first cape exceptions (B's rule,
//   shuffle.route_compact_unified's): 16 ids per lane per 512-sample step,
//   one shuffle scan of packed counts ranks a step, a lane visits only its
//   set bits, the kept escapes' values are one 16-byte load per word that
//   keeps any, all issued before the first store; the rows' zero tails go
//   out in 16-byte stores.
// The ids are masked as they are read (id_word): 0 at the DC column and at
// samples past the tile's valid count.
#pragma once

#include "dpk_walk.cuh"

namespace dctz {
namespace stages {

using walk::Walk;
using walk::pack4;

constexpr int LDQ = 33;  // words per row of the nibble copy (32 + 1 pad)

struct Smem {
  unsigned nib[BS * LDQ];            // row p, word q: nibbles of blocks 8q..8q+7
  unsigned cnt[walk::WARPS][4][16];  // per warp: counts >= 1, 3, 7, 15 (bytes:
                                     // positions 4c .. 4c+3 at [.][.][c])
  uint8_t wd[BS];                    // widths
};

// Ids of positions 4c .. 4c+3 of tile block kb, masked: 0 at the DC column
// (dcm: the lane's mask, 0xffffff00 at c = 0) and at samples at or past
// `valid`, the tile's count of valid samples (all of them when full).
__device__ __forceinline__ unsigned id_word(const uint8_t* __restrict__ raw,
                                            int kb, int c, unsigned dcm,
                                            bool full, int valid) {
  unsigned v = *reinterpret_cast<const unsigned*>(raw + kb * BS + 4 * c) & dcm;
  if (!full) {
    const int rem = valid - (kb * BS + 4 * c);
    if (rem < 4) v = rem <= 0 ? 0u : v & ((1u << (8 * rem)) - 1u);
  }
  return v;
}

// The DC mask of id_word for word column c.
__device__ __forceinline__ unsigned dc_mask(int c) {
  return c == 0 ? 0xffffff00u : 0xffffffffu;
}

// Eight nibbles (4 bits each, value s at bit 4s) clamped to 2^w - 1 and
// gathered to w bits each (value s at bit w*s).
__device__ __forceinline__ unsigned gather1(unsigned x) {
  unsigned y = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
  y = (y | (y >> 3)) & 0x03030303u;
  y = (y | (y >> 6)) & 0x000f000fu;
  return (y | (y >> 12)) & 0xffu;
}

__device__ __forceinline__ unsigned gather2(unsigned x) {
  const unsigned sat = ((x >> 2) | (x >> 3)) & 0x11111111u;
  unsigned y = (x & 0x33333333u) | (sat * 3u);
  y = (y | (y >> 2)) & 0x0f0f0f0fu;
  y = (y | (y >> 4)) & 0x00ff00ffu;
  return (y | (y >> 8)) & 0xffffu;
}

__device__ __forceinline__ unsigned gather3(unsigned x) {
  const unsigned sat = ((x >> 3) | (x & (x >> 1) & (x >> 2))) & 0x11111111u;
  unsigned y = (x & 0x77777777u) | (sat * 7u);
  y = (y & 0x07070707u) | ((y >> 1) & 0x38383838u);
  y = (y & 0x003f003fu) | ((y >> 2) & 0x0fc00fc0u);
  return (y & 0x00000fffu) | ((y >> 4) & 0x00fff000u);
}

__device__ __forceinline__ void st8(uint8_t* p, unsigned lo, unsigned hi) {
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

__device__ __forceinline__ void st16(uint8_t* p, unsigned a, unsigned b,
                                     unsigned c, unsigned d) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
}

// Values 64i .. 64i+63 of packed row p (nibble words v) at width w: 8w
// bytes at offset 8wi, and this thread's quarter of the zero tail past 32w.
__device__ __forceinline__ void pack_quarter(uint8_t* __restrict__ dst, int w,
                                             int i, const unsigned (&v)[8]) {
  switch (w) {
    case 0:
      st16(dst + 32 * i, 0, 0, 0, 0);
      st16(dst + 32 * i + 16, 0, 0, 0, 0);
      break;
    case 1: {
      unsigned b[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) b[k] = gather1(v[k]);
      st8(dst + 8 * i, b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
          b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24));
#pragma unroll
      for (int k = 0; k < 3; ++k) st8(dst + 32 + 24 * i + 8 * k, 0, 0);
      break;
    }
    case 2: {
      unsigned h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = gather2(v[k]);
      st16(dst + 16 * i, h[0] | (h[1] << 16), h[2] | (h[3] << 16),
           h[4] | (h[5] << 16), h[6] | (h[7] << 16));
      st16(dst + 64 + 16 * i, 0, 0, 0, 0);
      break;
    }
    case 3: {
      unsigned g[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) g[k] = gather3(v[k]);
      // eight little-endian 24-bit groups: 24 bytes
      st8(dst + 24 * i, g[0] | (g[1] << 24), (g[1] >> 8) | (g[2] << 16));
      st8(dst + 24 * i + 8, (g[2] >> 16) | (g[3] << 8), g[4] | (g[5] << 24));
      st8(dst + 24 * i + 16, (g[5] >> 8) | (g[6] << 16), (g[6] >> 16) | (g[7] << 8));
      st8(dst + 96 + 8 * i, 0, 0);
      break;
    }
    default:  // 4: the nibble words themselves
      st16(dst + 32 * i, v[0], v[1], v[2], v[3]);
      st16(dst + 32 * i + 16, v[4], v[5], v[6], v[7]);
  }
}

// Zero bytes [from, to) of a row (16-byte aligned when vec), by the row's
// lanes: single bytes up to a 16-byte boundary, then 16-byte stores.
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ row, int from,
                                           int to, const Walk& wk, bool vec) {
  const int v0 = vec ? min((from + 15) & ~15, to) : to;
  for (int q = from + wk.gl; q < v0; q += wk.width) row[q] = 0;
  for (int q = v0 + 16 * wk.gl; q < to; q += 16 * wk.width)
    *reinterpret_cast<uint4*>(row + q) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void zero_floats(float* __restrict__ row, int from,
                                            int to, const Walk& wk, bool vec) {
  const int v0 = vec ? min((from + 3) & ~3, to) : to;
  for (int q = from + wk.gl; q < v0; q += wk.width) row[q] = 0.f;
  for (int q = v0 + 4 * wk.gl; q < to; q += 4 * wk.width)
    *reinterpret_cast<float4*>(row + q) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The nibble copy and the threshold counts of the tile's ids: units (8
// blocks, 4 positions), half-warps on neighbouring groups of 8 blocks, which
// read their blocks in swapped pairs so that the two halves hit other banks.
// The caller synchronizes before select_widths reads the counts.
__device__ __forceinline__ void nibbles_and_counts(
    const uint8_t* __restrict__ raw, Smem& s, int tid, bool full, int valid) {
  const int lane = tid & 31, wid = tid >> 5;
  const int c = lane & 15, h = lane >> 4;  // word column, half-warp
  const unsigned dcm = dc_mask(c);
  unsigned n1 = 0, n3 = 0, n7 = 0, n15 = 0;
#pragma unroll
  for (int su = 0; su < 2; ++su) {
    const int q = 2 * wid + h + 16 * su;
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = walk::clamp15(id_word(raw, 8 * q + (i ^ h), c, dcm, full, valid));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      n1 += walk::ge_bytes_of(w[i], 0x01010101u) >> 7;
      n3 += walk::ge_bytes_of(w[i], 0x03030303u) >> 7;
      n7 += walk::ge_bytes_of(w[i], 0x07070707u) >> 7;
      n15 += walk::ge_bytes_of(w[i], 0x0f0f0f0fu) >> 7;
    }
    unsigned pr[4];  // byte j: nibbles of blocks 2k (low) and 2k+1 at 4c+j
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned lo = h ? w[2 * k + 1] : w[2 * k];
      const unsigned hi = h ? w[2 * k] : w[2 * k + 1];
      pr[k] = lo | (hi << 4);
    }
    const unsigned t0 = __byte_perm(pr[0], pr[1], 0x5140);
    const unsigned t1 = __byte_perm(pr[0], pr[1], 0x7362);
    const unsigned t2 = __byte_perm(pr[2], pr[3], 0x5140);
    const unsigned t3 = __byte_perm(pr[2], pr[3], 0x7362);
    unsigned* dst = s.nib + 4 * c * LDQ + q;
    dst[0] = __byte_perm(t0, t2, 0x5410);
    dst[LDQ] = __byte_perm(t0, t2, 0x7632);
    dst[2 * LDQ] = __byte_perm(t1, t3, 0x5410);
    dst[3 * LDQ] = __byte_perm(t1, t3, 0x7632);
  }
  n1 += __shfl_xor_sync(FULL, n1, 16);
  n3 += __shfl_xor_sync(FULL, n3, 16);
  n7 += __shfl_xor_sync(FULL, n7, 16);
  n15 += __shfl_xor_sync(FULL, n15, 16);
  if (h == 0) {
    s.cnt[wid][0][c] = n1;
    s.cnt[wid][1][c] = n3;
    s.cnt[wid][2][c] = n7;
    s.cnt[wid][3][c] = n15;
  }
}

// Width per position (threads 0 .. 63): cost w*256 + 8*#(nib >= 2^w - 1),
// first minimum, into s.wd and the tile's width row.
__device__ __forceinline__ void select_widths(Smem& s, int tid,
                                              uint8_t* __restrict__ width_tile) {
  if (tid >= BS) return;
  int cnt[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int sum = 0;
#pragma unroll
    for (int wp = 0; wp < walk::WARPS; ++wp)
      sum += walk::byte_of(s.cnt[wp][k][tid >> 2], tid & 3);
    cnt[k] = sum;
  }
  int best = cnt[0] == 0 ? 0 : (1 << 30), wd = 0;
#pragma unroll
  for (int wb = 1; wb <= 4; ++wb) {
    const int cost = wb * TILE_B + 8 * cnt[wb - 1];
    if (cost < best) {
      wd = wb;
      best = cost;
    }
  }
  s.wd[tid] = static_cast<uint8_t>(wd);
  width_tile[tid] = static_cast<uint8_t>(wd);
}

// Packing: thread (p, i) = (tid >> 2, tid & 3), values 64i .. 64i+63 of row
// p, into the tile's 64 packed rows of 128 bytes.
__device__ __forceinline__ void pack_tile(const Smem& s, int tid,
                                          uint8_t* __restrict__ packed_tile) {
  const int p = tid >> 2, i = tid & 3;
  unsigned v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = s.nib[p * LDQ + 8 * i + k];
  pack_quarter(packed_tile + p * 128, s.wd[p], i, v);
}

// The chunk rows of the tile (rows of cw samples, tile rows from exc_t /
// ac_t, counts from exc_cnt_t / ac_cnt_t): exceptions (nib >= 2^w - 1) into
// cape slots, zero-filled, with the true counts. KEEP (kernel B): also the
// AC escapes among the first cape exceptions into cape slots of ac_t, their
// values read from vals_t (the tile's samples, block rows), and the true
// escape counts into ac_cnt_t. One warp per unit of max(cw, 512) samples.
template <bool KEEP>
__device__ __forceinline__ void walk_exceptions(
    const uint8_t* __restrict__ raw, const Smem& s, const Walk& wk, int wid,
    bool full, int valid, int cape, uint8_t* __restrict__ exc_t,
    int* __restrict__ exc_cnt_t, float* __restrict__ ac_t,
    int* __restrict__ ac_cnt_t, const float* __restrict__ vals_t) {
  const unsigned dcm = dc_mask(wk.m);
  const bool vec_e = cape % 16 == 0, vec_a = cape % 4 == 0;
  const unsigned wword = *reinterpret_cast<const unsigned*>(s.wd + 4 * wk.m);
  unsigned thrw = 0;  // markers of positions 4m .. 4m+3; 16 at w = 0
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int w = walk::byte_of(wword, j);
    thrw |= (w ? (1u << w) - 1u : 16u) << (8 * j);
  }
  for (int u = wid; u < wk.units; u += walk::WARPS) {
    int ecarry = 0, kcarry = 0, acarry = 0;
    for (int st = u * wk.steps; st < (u + 1) * wk.steps; ++st) {
      unsigned v[4], eb[4];
      int ce[4], ae[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = id_word(raw, wk.block(st, k), wk.m, dcm, full, valid);
        eb[k] = walk::ge_bytes_of(walk::clamp15(v[k]), thrw);
        ce[k] = __popc(eb[k]);
        ae[k] = KEEP ? __popc(walk::ff_bytes_of(v[k])) : 0;
      }
      const unsigned ci = pack4(ce[0], ce[1], ce[2], ce[3]);
      const unsigned cinc = wk.scan(ci);
      const unsigned etot = wk.total(ci);
      int ebase[4], abase[4];
      ecarry = wk.bases(st, etot, ecarry, ebase);
      unsigned atot = 0;
      if constexpr (KEEP) {
        atot = wk.total(pack4(ae[0], ae[1], ae[2], ae[3]));
        acarry = wk.bases(st, atot, acarry, abase);
      }
      // exception bytes into their rows; KEEP: the escapes among the first
      // cape exceptions are kept
      unsigned keep[4];
      int ck[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint8_t* erow = exc_t + wk.row(st, k) * cape;
        int rank = ebase[k] + walk::byte_of(cinc - ci, k);
        unsigned kp = 0;
        for (unsigned mk = eb[k]; mk && rank < cape; mk &= mk - 1, ++rank) {
          const int bsh = walk::low_byte_bit(mk);
          const unsigned id = (v[k] >> bsh) & 0xffu;
          erow[rank] = static_cast<uint8_t>(id);
          if (KEEP && id == ESCAPE) kp |= 0x80u << bsh;
        }
        keep[k] = kp;
        ck[k] = __popc(kp);
      }
      int kbase[4];
      unsigned kinc = 0, ki = 0, ktot = 0;
      float4 kv[4];
      if constexpr (KEEP) {
        ki = pack4(ck[0], ck[1], ck[2], ck[3]);
        kinc = wk.scan(ki);
        ktot = wk.total(ki);
        kcarry = wk.bases(st, ktot, kcarry, kbase);
        // the kept values: one 16-byte load per word that keeps any, all
        // issued before the first store
#pragma unroll
        for (int k = 0; k < 4; ++k)
          kv[k] = keep[k] ? *reinterpret_cast<const float4*>(
                                vals_t + wk.block(st, k) * BS + 4 * wk.m)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = wk.row(st, k);
        float* arow = KEEP ? ac_t + r * cape : nullptr;
        if constexpr (KEEP) {
          int rank = kbase[k] + walk::byte_of(kinc - ki, k);
          for (unsigned mk = keep[k]; mk; mk &= mk - 1, ++rank) {
            const int j = walk::low_byte_bit(mk) >> 3;
            arow[rank] = j == 0 ? kv[k].x : j == 1 ? kv[k].y : j == 2 ? kv[k].z : kv[k].w;
          }
        }
        // a row ends: its zero tails and its true counts
        if (wk.ends(st, k)) {
          const int ecount = ebase[k] + walk::byte_of(etot, k);
          zero_bytes(exc_t + r * cape, min(ecount, cape), cape, wk, vec_e);
          if constexpr (KEEP)
            zero_floats(arow, kbase[k] + walk::byte_of(ktot, k), cape, wk, vec_a);
          if (wk.gl == 0) {
            exc_cnt_t[r] = ecount;
            if constexpr (KEEP) ac_cnt_t[r] = abase[k] + walk::byte_of(atot, k);
          }
        }
      }
    }
  }
}

}  // namespace stages
}  // namespace dctz
