// Kernel M_ref: the reference one-pass DPK decode, a card-only check. It is
// the first design of kernel M, kept unchanged in its arithmetic so that it
// stays an implementation independent of the headers the kernels of the
// codec run on: the per-thread inverse transform of common.cuh (inverse_dct)
// against the register-tiled one of dct_tile.cuh, and per-byte unpacking and
// one-ballot-per-32-samples chunk-row walks against the word-wide walks of
// dpk_walk.cuh. Nothing on an API path calls it; only chip_smoke.py and
// tests/test_torch_cuda.py do, through ops/research/_ref.py. Those hold
// M_ref bit-equal to C + D (EC) and C + D-QT (QT) at tile 256, and the
// redesigned M (fused_decode_dpk.cu) bit-equal to M_ref.
//
// Its output is that of kernel M, the port of
// dctz_tpu/ops/research/fused_decode.py (fused_decode_dpk, pallas_call at
// line 380, body _kernel lines 152-290); plain version:
// ops/research/fused_decode.py:_fused_decode_dpk_plain.
//
// One CUDA block per tile of b blocks, b rounded up to whole warps of
// threads. Dynamic shared memory holds the tile's packed rows (64 rows of
// b/2 bytes), its nibbles block-major, its coefficients (rows padded to 65
// floats) and the 64x64 basis. Shifts unpack the rows; one warp per chunk
// row ranks its exceptions (nibble == 2^w - 1) and then the escapes with
// __ballot_sync/__popc and reads the r-th stored byte and value. Each lane
// writes its dequantized coefficient into shared memory (common.cuh:center_of
// and qt_inverse, kernel D's arithmetic), and each thread inverts its block
// with common.cuh:inverse_dct, the same fmaf chains as D's tiled transform.
// QT inverts ((v - side) / denom) * q[k] with denom = f32(eb) * f32(qt_factor).
//
// 108 KB of shared memory at b = 256 allow two 256-thread blocks per SM; it
// is a check, not a path, and its time is kept for the record only.

#include "common.cuh"

namespace {

using namespace dctz;

constexpr int LD = 65;      // padded float row of the coefficient tile
constexpr int MAX_B = 256;  // blocks per tile: one thread per block

size_t smem_bytes(int b) {
  // basis, qtable, coefficients, widths, nibbles, packed rows
  return sizeof(float) * (BS * BS + BS + static_cast<size_t>(b) * LD) +
         sizeof(int) * BS + static_cast<size_t>(b) * BS + BS * (b / 2);
}

__global__ void __launch_bounds__(MAX_B)
    fused_decode_dpk_ref_kernel(const uint8_t* __restrict__ width,
                            const uint8_t* __restrict__ packed,
                            const uint8_t* __restrict__ exc_rows,
                            const float* __restrict__ ac_rows,
                            const float* __restrict__ dc,
                            const float* __restrict__ basis,
                            const float* __restrict__ sf_p,
                            const float* __restrict__ qtable, long long nblk,
                            long long nce, long long ncc, int b, int cw,
                            int cape, int capc, float w, float rmin,
                            float rmax, float denom, int qt,
                            float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sB = smem;             // basis B[k][m]
  float* sQ = sB + BS * BS;     // qtable (QT only)
  float* sC = sQ + BS;          // coefficients, then samples, block-major
  int* sW = reinterpret_cast<int*>(sC + b * LD);
  uint8_t* sN = reinterpret_cast<uint8_t*>(sW + BS);  // nibbles, block-major
  uint8_t* sP = sN + b * BS;                          // packed rows

  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5;
  const int half = b / 2;
  const long long tile = blockIdx.x;
  const long long blk0 = tile * b;
  const float sf = *sf_p;

  for (int i = tid; i < BS * BS; i += nth) sB[i] = basis[i];
  for (int i = tid; i < BS; i += nth) {  // a tile of 32 blocks has 32 threads
    sW[i] = width[tile * BS + i];
    sQ[i] = qt ? qtable[i] : 0.f;
  }
  {
    const uint8_t* src = packed + tile * BS * half;
    for (int i = tid; i < BS * half; i += nth) sP[i] = src[i];
  }
  __syncthreads();

  // unpack: value k of position row p sits at bit k*w of the row; a width-3
  // field may straddle into the next byte (the last byte of the row at most)
  for (int idx = tid; idx < BS * b; idx += nth) {
    const int p = idx / b, k = idx - p * b;
    const int wd = sW[p];
    const uint8_t* row = sP + p * half;
    int nib = 0;
    if (wd > 0) {
      const int bit = k * wd, by = bit >> 3;
      const int lo = row[by];
      const int hi = wd == 3 ? row[min(by + 1, half - 1)] : 0;
      nib = ((lo | (hi << 8)) >> (bit & 7)) & ((1 << wd) - 1);
    }
    sN[k * BS + p] = static_cast<uint8_t>(nib);
  }
  __syncthreads();

  // chunk rows: exceptions take the next stored byte, then escapes (id ==
  // ESCAPE off the DC column) the next stored AC value; each lane writes its
  // dequantized coefficient
  const int g = cw / BS;
  const int cpt = b * BS / cw;
  const unsigned below = lanes_below();
  for (int r = wid; r < cpt; r += nth / 32) {
    const long long row = tile * cpt + r;
    const bool have_e = row < nce, have_c = row < ncc;
    int ecount = 0, acount = 0;
    for (int e0 = 0; e0 < cw; e0 += 32) {
      const int e = e0 + lane;
      const int blk = r * g + (e >> 6), pos = e & 63;
      const long long gblk = blk0 + blk;
      const int nib = sN[blk * BS + pos];
      const int wd = sW[pos];
      const bool m = wd > 0 && nib == (1 << wd) - 1;
      const unsigned bm = __ballot_sync(FULL, m);
      const int rank = ecount + __popc(bm & below);
      int id = nib;
      if (m) id = (have_e && rank < cape) ? exc_rows[row * cape + rank] : 0;
      if (pos == 0) id = ESCAPE;
      const bool real = gblk < nblk;
      const bool esc = pos >= 1 && id == ESCAPE && real;
      const unsigned ba = __ballot_sync(FULL, esc);
      const int arank = acount + __popc(ba & below);
      float co = 0.f;
      if (pos == 0) {
        if (real) co = dc[gblk];
      } else if (esc) {
        const float av = (have_c && arank < capc) ? ac_rows[row * capc + arank] : 0.f;
        co = qt ? qt_inverse(av, sQ[pos], denom, rmin, rmax) : av;
      } else if (real) {
        co = center_of(id, w);
      }
      sC[blk * LD + pos] = co;
      ecount += __popc(bm);
      acount += __popc(ba);
    }
  }
  __syncthreads();

  if (tid < b) {
    float* cr = sC + tid * LD;
    float c[BS];
#pragma unroll
    for (int k = 0; k < BS; ++k) c[k] = cr[k];
    inverse_dct(c, sB, sf, cr);
  }
  __syncthreads();

  for (int i = tid; i < b * BS; i += nth) {
    const long long gblk = blk0 + (i >> 6);
    if (gblk < nblk) out[gblk * BS + (i & 63)] = sC[(i >> 6) * LD + (i & 63)];
  }
}

}  // namespace

extern "C" int dctz_fused_decode_dpk_ref(const uint8_t* width, const uint8_t* packed,
                                     const uint8_t* exc_rows,
                                     const float* ac_rows, const float* dc,
                                     const float* basis, const float* sf,
                                     const float* qtable, long long nblk,
                                     long long nce, long long ncc, int b,
                                     int cw, int cape, int capc, float w,
                                     float rmin, float rmax, float denom,
                                     int qt, float* out, void* stream) {
  if (b < 2 || b > MAX_B || b % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(b);
  cudaFuncSetAttribute(fused_decode_dpk_ref_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem_bytes(MAX_B)));
  const long long tiles = (nblk + b - 1) / b;
  const int threads = (b + 31) / 32 * 32;
  fused_decode_dpk_ref_kernel<<<static_cast<unsigned>(tiles), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      width, packed, exc_rows, ac_rows, dc, basis, sf, qtable, nblk, nce, ncc,
      b, cw, cape, capc, w, rmin, rmax, denom, qt, out);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at the launch configuration of the main path (tile 256).
extern "C" int dctz_ctas_per_sm_fused_decode_dpk_ref() { return dctz::ctas_per_sm(fused_decode_dpk_ref_kernel, MAX_B, smem_bytes(MAX_B)); }
