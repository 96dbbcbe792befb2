#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dctz_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out build/chip_smoke.json]
    python3 chip_smoke.py --multi-card    # two or more cards: phases 1, 2
                                          # and multi_card_phase alone

Drives the port's paths once each at full size and checks them.
Thirty-two paths, on 32Mi float32 elements (128 MB) unless named otherwise:

  DPK v2, the bench.py configuration (eb 1e-3, v2 container, DPK ids, verify
  on): EC and QT, each monolithic (segment_elems=0) and as the DTZS stream
  that the default segment_elems="auto" writes at this size (two frames of
  16Mi), on the bench array; EC DTZS is what bench.py measures. QT also on
  the bench array with every 977th sample x30, so that the quantizer table
  has entries > 1 (qt_x30, qt_x30_dtzs).
  v1 and host-coded v2: v1_ec (dz.compress(x) with no config: v1 EC, verify
  off), v1_qt (verify off), v1_ec_verify (verify on, the eval harness's
  row), v1_cesm (verify on, 3600x1800 = 6,480,000 elements, the length of
  one CESM field: n % 1024 = 128 takes the generic chain, chunk width 128)
  and v2_deflate (ids_codec="deflate", segment_elems=0, verify on).
  dpk_onepass, the research entry points on the bench array: the one-pass
  encode (kernel L) and decode (kernel M) at tile 256; kernel F, then
  idpack.pack_ids_with_ac at tile 64 (kernel J), then M at tile 64; and
  shuffle.compact_bytes (kernel K, which no caller reaches) on the DPK
  exception bytes, equal to L's exception rows, in its word walk.
  The relaxed analysis, dct_precision="high" (three bfloat16 products on the
  tensor cores, the RELAXED instantiations of A, A-QT, E, F and G), on the
  bench array: ec_high_dtzs (bench.py's configuration: A-relaxed once per
  16Mi frame), qt_high (DPK QT, monolithic: E-relaxed, A-QT-relaxed),
  v1_ec_high (v1 EC, verify on: F-relaxed and the HIGHEST repair) and
  v1_qt_high (v1 QT, verify on: E-relaxed, G-relaxed).
  Host-coded DTZS frames (the generic segment path: the transform, bins and
  repair as torch ops, kernel H per frame, I and D per frame on decode):
  v2_deflate_dtzs (ids_codec="deflate", segment_elems="auto", verify on:
  two 16Mi frames), v2_qt_x30_dtzs (the same in QT on the x30 input: the
  global column max over both segments, and H's full-width retry in each
  frame where a chunk row holds more than 128 escapes) and v1_seg
  (CodecConfig(segment_elems=1 << 24), the package's v1 defaults, which
  write host-coded v2 frames, their ids in native rANS where the library
  builds). And ec_dcd_dtzs: bench.py's configuration with dc_delta=True
  (the DC delta on the device before the byte-plane split), whose decode
  must equal ec_dtzs's bit for bit.
  Float64, on bench64 (the bench formula evaluated in float64 arithmetic at
  32Mi, 256 MB; not a cast of the float32 array) unless named otherwise, at
  full width (the generic chain's transform, bins, repair and, on decode,
  dequantization and inverse transform as float64 torch ops); each decodes
  to float64, launches its kernels and never kernel D: ec_f64_dtzs
  (bench.py's configuration: two 16Mi host-coded float64 frames, their ids
  in Huffman-only deflate; H and I once a frame), ec_f64 (the same with
  segment_elems=0: the XLA chain's DPK container of the true length; B on
  encode, C on decode), ec_f64_fast (ec_f64 with internal_dtype="float32":
  the float32 kernels A and B, the header declaring float64, C and the
  float64 decode), v1_f64_cesm (CodecConfig(), the native codec's
  settings, on the CESM-length formula in float64; H and I) and
  qt_f64_dtzs (ec_f64_dtzs in QT: the float64 global qtable pre-pass).
  The codec options of ROADMAP item 9: ec_auto_dtzs (bench.py's
  configuration with rate="auto": monolithic trial encodes on the 4Mi
  sample, A and B each, then two 16Mi DTZS frames at the chosen brsf; C and
  D on decode), qt_auto (QT, monolithic, rate="auto": E, A-QT, B; C, D-QT
  at the chosen brsf), v2_deflate_brsf (host-coded v2, brsf=2, verify on:
  the generic chain with H, then I and D; kernel F must not launch),
  ec_bs128 (DPK v2 at block_size=128: the XLA chain's DPK route with J,
  no A, B, C or D; decode in torch ops with I), v2_nbins63 (host-coded v2,
  nbins=63, verify on: H and I, no D), v1_f64_full_cesm
  (CodecConfig(truncate=False) on the CESM length in float64: v1 with
  8-byte DC and AC streams, the compaction in torch ops, no H or I) and
  ec_f64_full_dtzs (the DPK configuration with truncate=False on bench64:
  host-coded float64 frames with 8-byte sections, no H or I).

Phases, each printed as one JSON line:

  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build:  the CUDA kernels compiled from dctz_tpu_torch/csrc (one nvcc per
     source, in parallel), with ptxas' registers and spills per kernel; then
     one "occupancy" line per kernel: its resident CTAs per SM at its launch
     configuration (cudaOccupancyMaxActiveBlocksPerMultiprocessor, from the
     kernels' library; for C the lesser of its two instantiations, the
     staged one at its largest buffers) beside those registers and spills.
     A, A-QT, B, C (both instantiations), D, D-QT, E, F, G, H, J, K, L and
     M (C, H, J, K and M in both instantiations) and the RELAXED
     instantiations of A, A-QT, E, F and G must not spill, and their
     first instantiations must fit at least 2 CTAs per SM (H, J and K's word
     walks at their largest buffers on the API's paths, every capacity
     512); the lane walks of H, J and K and the card-only references L_ref
     and M_ref get occupancy lines too
  3. kernels against their plain PyTorch versions on the card, at the main
     paths' shapes. EC input (the bench array): B and C byte-equal, A within
     1e-5 of ids, D within 32 ulp of sf. QT input (the x30 array): E
     bit-equal to the clamped maximum over A-EC's own coefficients and
     within 4 ulp of its plain version, A-QT within 1e-5 of ids and its
     stored values within the budget below, C byte-equal on the rows of the
     x30 QT container (whose overflowed exception rows take C's wide
     instantiation), D-QT within 32 ulp of sf *
     max|coef| of the block; "screen" lines: the share of blocks A's and
     A-QT's L2 screen sends to the exact check and the share repaired, on
     the bench and x30 inputs (A's optional counters; the plain version's
     counts beside them). The v1 paths' kernels on the bench array: F
     and G with no id mismatch and DC and stored values within the budget
     (F also equal to A's ids and coefficients), H byte-equal on F's
     escapes at capacity 128 in its word walk, and in its lane walk on the
     same mask viewed one byte off 16 (ops/shuffle.walk_of), and at v1_cesm's
     geometry (the generic chain's call, chunk width 128, its arguments
     taken from one compress of the CESM-sized input), I byte-equal on the
     rows the decode of the v1_ec container hands it (and equal to
     masked_scatter of its AC stream).
     The RELAXED instantiations on the bench array, each against its plain
     version (transform.dot_bf16x3 on the card): the largest coefficient
     difference in eps32 * max|x/sf| of its block beside RELAXED_BUDGET
     (stored QT escapes within that times eb*qt_factor/q[k] plus 4 ulp) and
     the ids that differ (at most 1e-5 of them); A-relaxed (verify off) =
     F-relaxed, A-QT-relaxed = G-relaxed and E-relaxed = the clamped maximum
     over A-relaxed's coefficients, bit for bit (E also on the x30 input,
     whose qtable has entries above 1); the HIGHEST arm beyond the
     budget somewhere; "screen" lines for A-relaxed and A-QT-relaxed (their
     budget is 1024 eps) beside A's and A-QT's.
     The last four on the bench array: L's integer streams byte-equal to
     its plain version's (AC and DC within 32 ulp of max|x/sf|), all its
     streams equal to F -> idpack.pack_ids -> H, and the card-only
     reference L_ref (ops/research/_ref.py, csrc/fused_encode_dpk_ref.cu:
     the per-thread common.cuh:forward_dct and the per-byte stages of
     dpk_tile.cuh) equal to that chain (the check of the tiled forward
     transform of A, E, F, G and L, csrc/dct_tile.cuh) and to L on all
     seven streams, bit for bit; B on A (verify off) equal to L_ref (width,
     packed, exception rows and counts, DC by value; the AC streams where
     no chunk row holds more than 128 exceptions), so that B's word-wide
     stages agree with the per-byte ones; M bit-equal to C + D on L's
     streams, within D's budget of its plain version at tile 64 (else 128
     or 32, whichever holds every chunk row in 128 slots) and in QT (G's
     streams with the x30 input's qtable from E, on the x30 input unless a
     chunk row there holds more than 128 exceptions, then on the bench
     array), and bit-equal to C + D-QT; M_ref (csrc/fused_decode_dpk_ref.cu,
     the per-thread common.cuh:inverse_dct) bit-equal to C + D and C +
     D-QT, and M bit-equal to M_ref at tiles 256 and 64, EC and QT, with
     the instantiation of M each took (fused_decode.walk_of, checked
     against the library's); J (pack_ids_with_ac at tile 64) and K
     byte-equal, each also called alone in its word walk and, on id bytes
     viewed 8 bytes off 16, in its lane walk (K's word walk also equal to
     L's exception rows). The item-9 operands ("item9_kernel_check"): A
     (verify on), A-QT, E, D and D-QT at brsf 2**(3/8) and 8 against their
     plain versions by the rules above; J at block size 128 on the XLA
     chain's DPK route byte-equal to its plain version and launched, and
     at 48 on the input cut to rows of 480 the same
  4. end to end, per path: compress and decompress through the public API on
     the card with the launch counters reset just before and read just after
     (every kernel of the path > 0, on a DTZS path at least once a frame
     besides the launches of rate="auto"'s trial encodes; H,
     J and K in their word walks, as dpk_fuse.INSTANTIATIONS counts them),
     the container family expected, the pointwise bound satisfied, the ratio
     within 0.1% of the plain (CPU) path's, each path's output decoded by
     the other within the bound, and a DPK DTZS decode bit-equal to the
     monolithic decode of the same data (ec_dcd_dtzs: to ec_dtzs's; every
     frame of it carries the dcd flag); host-coded DTZS frames, which run
     the generic chain, get a "generic_vs_monolithic" line instead (ratio
     and decode beside the monolithic path of their configuration); each
     end_to_end line names the frames, their ids codec, their dcd flags and
     how many frames retried H at full width (the relaxed paths: none of
     the HIGHEST forward kernels launched, and a "relaxed_vs_highest" line,
     the ratio and error beside the HIGHEST path of the same mode)
     (dpk_onepass: both decodes within the bound, every kernel > 0, K's rows
     equal to L's exception rows); the float64 paths: float64 output, no
     launch of D, a "generic_vs_monolithic" line for ec_f64_dtzs beside
     ec_f64
     The item-9 paths (NEVER): the kernels their gates exclude launch no
     time; an "item9_path" line: the stored item width (8 bytes on the
     full-width paths, whose v2 headers say truncate=False), the brsf, the
     ratio beside the same family at the default options (ITEM9_BESIDE)
     and, with rate="auto", each trial's brsf, bytes and seconds and the
     trials' share of the compress; and instead of the full-size cross
     check an "item9_card_vs_cpu" line on a PREFIX-sample prefix: the card's
     and the CPU's containers equal but for the mean, the same brsf chosen,
     each decoding the other's within the bound, and the card's and the
     CPU's decodes of the card's container equal byte for byte
  4b. f64_parity: the card's float64 v1 containers (EC and QT at n 32768,
     32799, 777 and the CESM length) against dctz_tpu_torch.native.compress
     (the C++ codec of cpp/, built on the card's host): EC byte-equal with
     the mean zeroed, QT the same sections and header minus the mean and
     the qtable within rtol 1e-15 (tests/test_parity_native.py's rules); a
     native library that does not build fails the phase
  4c. f64_card_vs_cpu: the five float64 configurations at n = 70001 (the
     segmented ones in 32768-element frames) on the card and on the CPU: the
     same containers by those rules; ec_f64_fast's float32 kernels differ
     from their plain versions in summation order, so it is held to the
     float32 paths' rule instead (the ratio within 0.1%, each decoding the
     other within the bound) and its byte equality is printed
  4d. drivers: the drivers and tools (ROADMAP item 11) through their entry
     points at their default device, the card. The CLI in process
     (dctz_tpu_torch.cli.main, --json), the launch counters reset before
     each run and read where it calls decompress: v1_ec (-f 1E-3 on the
     bench array: F and H on compress, I and D on decode), v2_dpk (bench.py's
     configuration, --container v2 --ids-codec device --verify: A and B,
     then C and D, once a DTZS frame), v1_qt (--mode qt: E, G and H; I and
     D-QT) and v1_f64_cesm (-d on the CESM-length formula in float64, dims
     1800 3600 and a solName, --verify: H and I, never D); each .z
     byte-equal to dz.compress of the same configuration in this process,
     each .z.r to dz.decompress of the .z, the bound satisfied, the CLI's
     own compress_s and decompress_s beside the API twin's. The harness:
     sweep("msst19") over the bounds 1e-3, 1e-4, 1e-5, EC and QT, the
     torch, native (where cpp/ builds) and auto engines, each torch row
     equal to its device="cpu" twin but the two speeds; sweep("cesm-atm")
     at 1e-3 (five synthetic 1800x3600 float32 fields, no sz_like: a
     Python loop), H on every dctz row; every dctz row within the bound.
     dctz_dump: dump on the four CLI containers and phase 4's ec
     container; extract on that one (its id stream's exception bytes on
     kernel I, which must launch once) and the v1_ec one (host code, no
     launch), the card's files byte-equal to the CPU's. dct_test on 1Mi prefixes of the bench array
     (float32) and the CESM-length formula (float64): max_diff and the scipy
     oracle's within 32 eps of max |x| (the transform's budget), the .x and
     .r within 32 eps of each block's max |x| of the CPU run's. Then the
     phase's wall time
  4e. sharded: multi-GPU (ROADMAP item 10) on the one card, at full width
     on the bench array. compress_sharded on sharding.make_mesh() (the
     card's count, 1) and on SHARDS (4) shards of cuda:0, bench.py's
     configuration: each container the monolithic ec container but for the
     mean (within MEAN_ULPS), A and B once a shard (a full-width retry
     counted and printed), C and D once a shard in decompress_sharded, whose
     output equals decompress of the same container bit for bit and holds
     the bound. QT on the x30 input over 4 shards (the chain body: H on
     encode, never A-QT; C and D-QT once a shard): the ratio within 0.1% of
     qt_x30's, and whether its sections equal qt_x30's (the mean and
     qtable[0] aside) printed, a finding, not a gate. ids_codec="deflate"
     over 4 shards: H on encode, I and D once a shard on decode. N - 12345
     samples over 4 shards (the last shard carries the padding): the bound,
     and the sharded decode equal to decompress. A CUDA tensor: padded and
     split on the card (Tensor.cpu, .numpy, .tolist and .to a host device
     raise meanwhile), the numpy input's bytes. Times (median of REPS warm
     runs): compress_sharded and decompress_sharded at 1 and 4 shards beside
     ec's compress and decompress. Then two ranks on the card, spawned as
     this script with --rank (rank_main; gloo on 127.0.0.1, NCCL refusing
     two ranks on one GPU; each with a timeout, a failure in any failing the
     phase): compress_multihost over N + 7 samples (the write's wall time,
     median of REPS warm runs), the concatenated parts decoded within the
     bound, decompress_multihost giving each rank its own frame equal to
     the full decode's slice, and the tile-range restore of the monolithic
     ec container equal to its decode's slices; A, B, C and D launched in
     every rank. Then the phase's wall time
  4f. suites: the evaluation sweeps of eval/run_suites_torch.sh that 4d
     leaves off the card, cut to a phase: randgen (EC, the three bounds;
     torch, native, auto), spectral at 1e-3 (EC and QT; torch, auto), the
     sharded engine on randgen and one point (PSNR_POINT) of spectral's
     matched-PSNR curve. The torch, native, sz_like and zlib rows held to
     the committed reference CSVs (ratio within 0.1%, PSNR within 0.01
     dB, bound_satisfied alike); the auto and sharded rows to their CPU
     twins in every column but the speeds (the reference CSVs resolve
     ids_codec="auto" by the JAX package's CPU rule, host coders, the port
     by its accelerator's, DPK); the launches of each row's compress and
     decode, H on every float32 torch row, a kernel on both sides of every
     float32 auto row. Then the phase's wall time
  4g. robustness: byte-flipped copies (XOR 0x5A, seeded positions) of
     phase 4's ec (256, a quarter in its header and tables), v2_deflate,
     ec_dtzs and v1_ec (the v1 header's unchecked fields left out)
     containers decoded on the card: each raises a clean exception, no
     decode kernel (C, D, D-QT, I) launches on a corrupted container (a
     DTZS stream's intact frames before the flip decode as usual), and
     each good container then decodes bit-equal to its phase-4 decode
  4h. bench: the port's benchmark entry point, dctz_tpu_torch.bench.run(),
     once at full size (bench.py's workload: the 32Mi array made on the
     card, the default DTZS path through the public API, the amortized
     device stages, the overlap, the 1 GB point, the C++ codec), the launch
     counters reset just before and read just after: A, B, C and D
     launched, the bound satisfied, the ratio within 0.1% of ec_dtzs's in
     this run; its compact last line printed on a line of its own. Then the
     phase's wall time
  5. times, per path: compress and decompress GB/s (median of warm runs,
     phase 4's run being the warm-up; the float64 paths in GB/s of their
     float64 input bytes; REPS_F64 runs for those and ZLIB_BOUND_PATHS)
     and their split into stages; a torch.profiler pass over one call of each
     direction of ec, ec_dtzs, v1_ec, v2_deflate_dtzs, ec_f64 and
     ec_f64_dtzs (device busy and idle share); one traced run of each direction of the bench-array DTZS
     paths (the stream's per-segment spans); each kernel's time beside its plain
     version's (CUDA events), its bound (B's counts the ids, the DC values
     and the escapes it keeps, not the whole coefficient array; the RELAXED
     instantiations' operations are bf16 tensor-core FLOPs) and, for H,
     I, J and K, one PyTorch
     call that computes the same function from or to the tight stream
     (library_ms); H a second time at v1_cesm's geometry, and H, J and K's
     lane walks on the views above (kernel_time lines, not in the table);
     for every kernel of the table the kernel's own device time from
     torch.profiler beside the wrapper's CUDA-event time (which also holds
     the wrapper's small launches and host time; kernel_device_time lines);
     B, C and H-K once each with the launch queued behind a device sleep,
     after the L2 cache was flushed (cold) and right after a call on the
     same inputs (warm: what L2 still holds), beside the table's time in a
     loop, and so H, J and K's lane walks (their design before the word
     walks) on the same inputs, and H's two walks at v1_cesm's geometry
     (kernel_l2 lines);
     then, for the record, L beside A
     (verify off) + B and beside F + pack_ids + H, M (tiles 256 and 64)
     beside C + D, L_ref and M_ref (onepass_vs_launches), and a
     transform-only yardstick, torch.matmul(blocks, basis.T) and
     torch.matmul(coef, basis) in full fp32 (transform_matmul_ms): not the
     same function as A or D, and never called by the port

Any failed check raises, and the script exits non-zero without a result.
Without CUDA it exits 2 at once. The line before the last two is the kernel
table {"kernels": [...]}, then the card's name and power limit, and the last
line is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

N = 1 << 25  # elements: 128 MB of float32, the benchmark's size
REPS = 3
REPS_F64 = 2
A_ID_MISMATCH_MAX = 1e-5
D_ULPS = 32
E_ULPS = 4
RATIO_REL_TOL = 1e-3
EPS32 = 2.0 ** -23
PEAK_FP32 = 67e12  # FLOP/s outside the tensor cores (NVIDIA data sheet, H100 SXM)
PEAK_BF16 = 989e12  # dense bf16 FLOP/s of the tensor cores (same sheet)
PEAK_BYTES = 3.35e12  # bytes/s of HBM3
#: a RELAXED kernel's coefficients against its plain version
#: (transform.dot_bf16x3), in eps32 * max|x/sf| of the block: both take the
#: same bfloat16 parts, whose products are exact in float32, so they differ
#: only by the order of the float32 accumulation inside each product (the
#: tensor cores' against cuBLAS'); tests/test_torch_cuda.py holds the same
RELAXED_BUDGET = 32

EC_KERNELS = ("dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand",
              "dequant_idct")
#: the kernels on the register-tiled transform (csrc/dct_tile.cuh) that
#: take one tile of 64 blocks per step (L and M take it too, in sub-tiles)
TILE_KERNELS = ("dct_quant_verify", "dct_quant_verify_qt", "dequant_idct",
                "dequant_idct_qt", "qtable_qmax", "dct_quant", "dct_quant_qt")
#: the redesigned kernels: no spill (C and M in both instantiations, which
#: ptxas lists apart), at least MIN_CTAS_PER_SM resident CTAs per SM
PERSISTENT_KERNELS = TILE_KERNELS + ("dpk_pack_compact", "dpk_unpack_expand",
                                     "fused_encode_dpk", "fused_decode_dpk",
                                     "chunk_compact", "chunk_compact_unified",
                                     "chunk_compact_bytes")
#: the second instantiations of C, M, H, J and K, which must not spill either
SECOND_INSTANTIATIONS = ("dpk_unpack_expand_wide", "fused_decode_dpk_lanes",
                         "chunk_compact_lanes", "chunk_compact_unified_lanes",
                         "chunk_compact_bytes_lanes")
#: the RELAXED instantiations (dct_precision="high": the bf16x3 analysis on
#: the tensor cores) of A, A-QT, E, F and G, by the name of their launch
#: counter and table row
RELAXED_KERNELS = ("dct_quant_verify_relaxed", "dct_quant_verify_qt_relaxed",
                   "qtable_qmax_relaxed", "dct_quant_relaxed", "dct_quant_qt_relaxed")
PERSISTENT_KERNELS += RELAXED_KERNELS
#: the template parameters of the kernels that take more than QT (ptxas_table
#: and DEVICE_TIME read the instantiation from them)
TEMPLATE_PARAMS = {"dct_quant_verify": ("qt", "relaxed"), "dct_quant": ("qt", "relaxed"),
                   "qtable_qmax": ("relaxed",)}


def symbol_of(name: str) -> str:
    """The demangled symbol of the instantiation that the table row `name`
    times, e.g. dct_quant_verify_kernel<true, false> for dct_quant_verify_qt."""
    base = name.removesuffix("_relaxed").removesuffix("_qt")
    params = TEMPLATE_PARAMS.get(base, ("qt",))
    flags = {"qt": base + "_qt" in name, "relaxed": name.endswith("_relaxed")}
    return base + "_kernel<" + ", ".join(
        "true" if flags[p] else "false" for p in params) + ">"


#: every kernel of the table, and the symbol by which phase 5 finds its own
#: device time in the profiler: the instantiation that the table's call
#: takes (C's staged one at the main path's capacities, H, J and K's word
#: walks; the template arguments of A, D, E, F and G)
DEVICE_TIME = {k: symbol_of(k) for k in TILE_KERNELS + RELAXED_KERNELS} | {
    k: k + "_kernel" for k in (
        "dpk_pack_compact", "dpk_unpack_expand", "fused_encode_dpk",
        "fused_decode_dpk", "chunk_compact", "chunk_expand",
        "chunk_compact_unified", "chunk_compact_bytes")}
#: kernels timed once more with a single queued launch, cold and warm in L2
L2_KERNELS = ("dpk_pack_compact", "dpk_unpack_expand", "chunk_compact", "chunk_expand",
              "chunk_compact_unified", "chunk_compact_bytes")
MIN_CTAS_PER_SM = 2
QT_KERNELS = ("qtable_qmax", "dct_quant_verify_qt", "dpk_pack_compact",
              "dpk_unpack_expand", "dequant_idct_qt")
V1_EC_KERNELS = ("dct_quant", "chunk_compact", "chunk_expand", "dequant_idct")
V1_QT_KERNELS = ("qtable_qmax", "dct_quant_qt", "chunk_compact", "chunk_expand",
                 "dequant_idct_qt")
#: the relaxed paths' kernels: the RELAXED forward instantiations and the
#: same packing and decode kernels as their HIGHEST paths
EC_HIGH_KERNELS = ("dct_quant_verify_relaxed",) + EC_KERNELS[1:]
QT_HIGH_KERNELS = ("qtable_qmax_relaxed", "dct_quant_verify_qt_relaxed") + QT_KERNELS[2:]
V1_EC_HIGH_KERNELS = ("dct_quant_relaxed",) + V1_EC_KERNELS[1:]
V1_QT_HIGH_KERNELS = ("qtable_qmax_relaxed", "dct_quant_qt_relaxed") + V1_QT_KERNELS[2:]
GENERIC_KERNELS = ("chunk_compact", "chunk_expand", "dequant_idct")
GENERIC_QT_KERNELS = ("chunk_compact", "chunk_expand", "dequant_idct_qt")
#: the one-pass DPK path (its own block in phase 4, not a PATHS entry: it
#: runs through the research entry points and pack_ids_with_ac, not
#: dz.compress); kernel F runs in it too
#: float64 at full width: the generic chain's H and I (v1, host-coded DTZS
#: frames) or the XLA chain's DPK container (B, C); internal_dtype
#: "float32": A, B and C. Never D: the float64 decode dequantizes and
#: inverts in torch ops
F64_GENERIC_KERNELS = ("chunk_compact", "chunk_expand")
F64_DPK_KERNELS = ("dpk_pack_compact", "dpk_unpack_expand")
F64_FAST_KERNELS = ("dct_quant_verify", "dpk_pack_compact", "dpk_unpack_expand")
D_KERNELS = ("dequant_idct", "dequant_idct_qt")
ONEPASS_KERNELS = ("fused_encode_dpk", "fused_decode_dpk", "chunk_compact_unified",
                   "chunk_compact_bytes")
N_CESM = 3600 * 1800  # one CESM field: n % 1024 == 128, the generic chain
DPK = dict(error_bound=1e-3, container="v2", ids_codec="device", verify=True)
#: path name -> (CodecConfig keywords, None for dz.compress(x)'s defaults;
#: input; kernels the path must launch). Each DTZS path follows the
#: monolithic path of the same mode and input.
PATHS = {
    "ec": (dict(DPK, mode="ec", segment_elems=0), "bench", EC_KERNELS),
    "ec_dtzs": (dict(DPK, mode="ec", segment_elems="auto"), "bench", EC_KERNELS),
    "qt": (dict(DPK, mode="qt", segment_elems=0), "bench", QT_KERNELS),
    "qt_dtzs": (dict(DPK, mode="qt", segment_elems="auto"), "bench", QT_KERNELS),
    "qt_x30": (dict(DPK, mode="qt", segment_elems=0), "x30", QT_KERNELS),
    "qt_x30_dtzs": (dict(DPK, mode="qt", segment_elems="auto"), "x30", QT_KERNELS),
    "v1_ec": (None, "bench", V1_EC_KERNELS),
    "v1_qt": (dict(mode="qt"), "bench", V1_QT_KERNELS),
    "v1_ec_verify": (dict(verify=True), "bench", V1_EC_KERNELS),
    "v1_cesm": (dict(verify=True), "cesm", GENERIC_KERNELS),
    "v2_deflate": (dict(container="v2", ids_codec="deflate", segment_elems=0,
                        verify=True), "bench", V1_EC_KERNELS),
    # dct_precision="high", the relaxed analysis
    "ec_high_dtzs": (dict(DPK, mode="ec", segment_elems="auto", dct_precision="high"),
                     "bench", EC_HIGH_KERNELS),
    "qt_high": (dict(DPK, mode="qt", segment_elems=0, dct_precision="high"), "bench",
                QT_HIGH_KERNELS),
    "v1_ec_high": (dict(verify=True, dct_precision="high"), "bench", V1_EC_HIGH_KERNELS),
    "v1_qt_high": (dict(mode="qt", verify=True, dct_precision="high"), "bench",
                   V1_QT_HIGH_KERNELS),
    # host-coded DTZS frames (the generic segment path), and the DC delta
    "v2_deflate_dtzs": (dict(container="v2", ids_codec="deflate", segment_elems="auto",
                             verify=True), "bench", GENERIC_KERNELS),
    "v2_qt_x30_dtzs": (dict(container="v2", ids_codec="deflate", segment_elems="auto",
                            verify=True, mode="qt"), "x30", GENERIC_QT_KERNELS),
    "v1_seg": (dict(segment_elems=1 << 24), "bench", GENERIC_KERNELS),
    "ec_f64": (dict(DPK, mode="ec", segment_elems=0), "bench64", F64_DPK_KERNELS),
    "ec_f64_dtzs": (dict(DPK, mode="ec", segment_elems="auto"), "bench64",
                    F64_GENERIC_KERNELS),
    "ec_f64_fast": (dict(DPK, mode="ec", segment_elems=0, internal_dtype="float32"),
                    "bench64", F64_FAST_KERNELS),
    "v1_f64_cesm": ({}, "cesm64", F64_GENERIC_KERNELS),
    "qt_f64_dtzs": (dict(DPK, mode="qt", segment_elems="auto"), "bench64",
                    F64_GENERIC_KERNELS),
    "ec_dcd_dtzs": (dict(DPK, mode="ec", segment_elems="auto", dc_delta=True), "bench",
                    EC_KERNELS),
    # the codec options of ROADMAP item 9: rate="auto" and brsf on kernels
    # A-E, a non-default block size or bin count on the generic chain and
    # the XLA chain's DPK route, truncate=False (8-byte float64 streams)
    "ec_auto_dtzs": (dict(DPK, mode="ec", segment_elems="auto", rate="auto"), "bench",
                     EC_KERNELS),
    "qt_auto": (dict(DPK, mode="qt", segment_elems=0, rate="auto"), "bench", QT_KERNELS),
    "v2_deflate_brsf": (dict(container="v2", ids_codec="deflate", segment_elems=0,
                             verify=True, brsf=2.0), "bench", GENERIC_KERNELS),
    "ec_bs128": (dict(DPK, mode="ec", segment_elems=0, block_size=128), "bench",
                 ("chunk_compact_unified", "chunk_expand")),
    "v2_nbins63": (dict(container="v2", ids_codec="deflate", segment_elems=0,
                        verify=True, nbins=63), "bench", ("chunk_compact", "chunk_expand")),
    "v1_f64_full_cesm": (dict(truncate=False), "cesm64", ()),
    "ec_f64_full_dtzs": (dict(DPK, mode="ec", segment_elems="auto", truncate=False),
                         "bench64", ()),
}
#: the fused kernels A-G (HIGHEST and RELAXED), which a non-default block
#: size or bin count never launches
A_TO_G = ("dct_quant_verify", "dct_quant_verify_qt", "dpk_pack_compact",
          "dpk_unpack_expand", "dequant_idct", "dequant_idct_qt", "qtable_qmax",
          "dct_quant", "dct_quant_qt") + RELAXED_KERNELS
#: the item-9 paths, and the kernels each must not launch: brsf != 1 on
#: host-coded v2 leaves F and G for the generic chain; the non-default
#: geometries leave A-G; float64 full-width values never pass through H or I
#: (nor D, as no float64 path)
NEVER = {
    "ec_auto_dtzs": ("dct_quant", "dct_quant_qt"),
    "qt_auto": ("dct_quant", "dct_quant_qt"),
    "v2_deflate_brsf": ("dct_quant", "dct_quant_qt", "dct_quant_verify",
                        "dct_quant_verify_qt"),
    "ec_bs128": A_TO_G,
    "v2_nbins63": A_TO_G,
    "v1_f64_full_cesm": ("chunk_compact", "chunk_expand") + D_KERNELS,
    "ec_f64_full_dtzs": ("chunk_compact", "chunk_expand") + D_KERNELS,
}
ITEM9_PATHS = tuple(NEVER)
#: the item-9 paths' card-against-CPU check runs on this prefix of the input
PREFIX = 1 << 20
#: each item-9 path and the path of the same family at the default options,
#: whose ratio it is printed beside
ITEM9_BESIDE = {"ec_auto_dtzs": "ec_dtzs", "qt_auto": "qt",
                "v2_deflate_brsf": "v2_deflate", "ec_bs128": "ec",
                "v2_nbins63": "v2_deflate", "v1_f64_full_cesm": "v1_f64_cesm",
                "ec_f64_full_dtzs": "ec_f64_dtzs"}
#: each relaxed path and the HIGHEST path of the same mode and container
#: whose ratio it is printed beside
HIGH_VS_HIGHEST = {"ec_high_dtzs": "ec_dtzs", "qt_high": "qt",
                   "v1_ec_high": "v1_ec_verify", "v1_qt_high": "v1_qt"}
#: the monolithic path whose decode a DTZS path's must equal bit for bit
#: (ec_dcd_dtzs: the same stream without the delta, which is lossless)
DTZS_TWIN = {"ec_dtzs": "ec", "qt_dtzs": "qt", "qt_x30_dtzs": "qt_x30",
             "ec_dcd_dtzs": "ec_dtzs"}
#: the monolithic path of a host-coded DTZS path's configuration, whose
#: ratio and decode it is printed beside: the frames run the generic chain
#: (torch.matmul transform, shuffle + deflate sections), the monolithic
#: containers kernel F and PLC sections, so neither the bytes nor the
#: decodes are equal
GENERIC_TWIN = {"v2_deflate_dtzs": "v2_deflate", "v1_seg": "v1_ec",
                "ec_f64_dtzs": "ec_f64"}
F64_INPUTS = ("bench64", "cesm64")
#: the 32Mi v1 paths, 99% one-thread zlib (3-4 s a compress): phase 5 times
#: them REPS_F64 times, as the float64 paths
ZLIB_BOUND_PATHS = ("v1_ec", "v1_qt", "v1_ec_verify", "v1_ec_high", "v1_qt_high")
F64_PATHS = ("ec_f64", "ec_f64_dtzs", "ec_f64_fast", "v1_f64_cesm", "qt_f64_dtzs")
#: the brsf values at which kernels A, A-QT, E, D and D-QT are held to their
#: plain versions (the second not a power of two: w and rmax rounded once)
CHECK_BRSFS = (2 ** (3 / 8), 8.0)
#: the path whose launch counts the kernel table reports (bench.py's
#: configuration for the DPK EC kernels, its QT twin for the QT ones, the
#: package's default, v1 EC, for the non-DPK kernels)
MAIN_PATH = {k: "ec_dtzs" for k in EC_KERNELS} | {
    k: "qt_dtzs" for k in QT_KERNELS if k not in EC_KERNELS} | {
    "dct_quant": "v1_ec", "chunk_compact": "v1_ec", "chunk_expand": "v1_ec",
    "dct_quant_qt": "v1_qt"} | {k: "dpk_onepass" for k in ONEPASS_KERNELS} | {
    "dct_quant_verify_relaxed": "ec_high_dtzs", "dct_quant_verify_qt_relaxed": "qt_high",
    "qtable_qmax_relaxed": "qt_high", "dct_quant_relaxed": "v1_ec_high",
    "dct_quant_qt_relaxed": "v1_qt_high"}
SOURCES = {
    "qtable_qmax": ("dctz_tpu_torch/csrc/qtable_qmax.cu",
                    "dctz_tpu/ops/fused_encode.py:203"),
    "dct_quant_verify": ("dctz_tpu_torch/csrc/dct_quant_verify.cu",
                         "dctz_tpu/ops/dpk_fuse.py:782"),
    "dct_quant_verify_qt": ("dctz_tpu_torch/csrc/dct_quant_verify.cu",
                            "dctz_tpu/ops/dpk_fuse.py:782"),
    "dpk_pack_compact": ("dctz_tpu_torch/csrc/dpk_pack_compact.cu",
                         "dctz_tpu/ops/dpk_fuse.py:782"),
    "dpk_unpack_expand": ("dctz_tpu_torch/csrc/dpk_unpack_expand.cu",
                          "dctz_tpu/ops/dpk_fuse.py:1041"),
    "dequant_idct": ("dctz_tpu_torch/csrc/dequant_idct.cu",
                     "dctz_tpu/ops/dpk_fuse.py:1041"),
    "dequant_idct_qt": ("dctz_tpu_torch/csrc/dequant_idct.cu",
                        "dctz_tpu/ops/dpk_fuse.py:1041"),
    "dct_quant": ("dctz_tpu_torch/csrc/dct_quant.cu",
                  "dctz_tpu/ops/fused_encode.py:363"),
    "dct_quant_qt": ("dctz_tpu_torch/csrc/dct_quant.cu",
                     "dctz_tpu/ops/fused_encode.py:294"),
    "chunk_compact": ("dctz_tpu_torch/csrc/chunk_shuffle.cu",
                      "dctz_tpu/ops/shuffle.py:422"),
    "chunk_expand": ("dctz_tpu_torch/csrc/chunk_shuffle.cu",
                     "dctz_tpu/ops/shuffle.py:435"),
    "chunk_compact_unified": ("dctz_tpu_torch/csrc/chunk_shuffle.cu",
                              "dctz_tpu/ops/shuffle.py:392"),
    "chunk_compact_bytes": ("dctz_tpu_torch/csrc/chunk_shuffle.cu",
                            "dctz_tpu/ops/shuffle.py:409"),
    "fused_encode_dpk": ("dctz_tpu_torch/csrc/fused_encode_dpk.cu",
                         "dctz_tpu/ops/research/fused_encode_dpk.py:360"),
    "fused_decode_dpk": ("dctz_tpu_torch/csrc/fused_decode_dpk.cu",
                         "dctz_tpu/ops/research/fused_decode.py:380"),
}
#: the RELAXED instantiations replace the relaxed arms of the same TPU
#: kernels (dpk_fuse.py:510-516; fused_encode.py:122-131, :92-103, :148-173)
SOURCES |= {k: SOURCES[k.removesuffix("_relaxed")] for k in RELAXED_KERNELS}
#: what the library yardstick of a kernel computes, where there is one
LIBRARY_NOTE = {
    "chunk_compact": "torch.masked_select(vals, mask): the tight stream the "
                     "host assembles from H's rows, not the rows",
    "chunk_expand": "out.masked_scatter_(mask, tight): from the tight "
                    "stream, not from rows",
    "chunk_compact_unified": "torch.masked_select(id_bytes, mask): the tight "
                             "exception stream alone, not the AC rows",
    "chunk_compact_bytes": "torch.masked_select(id_bytes, mask): the tight "
                           "stream, not the rows",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events), after
    one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, flush=None) -> float:
    """Milliseconds of one call of fn between CUDA events, the call queued
    behind a device sleep so that the host's time in the wrapper does not
    count; flush, when given, is written first (more bytes than the card's
    L2 holds)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if flush is not None:
        flush.fill_(1.0)
    torch.cuda._sleep(2_000_000)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def wall_s(fn, reps: int, warm: bool = True) -> float:
    """Median wall seconds of fn() over warm runs ending in a synchronize;
    warm=False: fn already ran warm (no warm-up call)."""
    import torch

    if warm:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ptxas_table(log: str) -> dict:
    """Registers, stack and spills per kernel (the QT and RELAXED
    instantiations of the templated kernels get a _qt and a _relaxed suffix,
    TEMPLATE_PARAMS) from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for ln in log.splitlines():
        # mangled: ...<length><name>_kernel[I(Lb<0|1>E)+E]...
        m = re.search(r"entry function '.*?\d+([a-z_]+)_kernel((?:Lb[01]E|I)*)", ln)
        if m:
            name = m.group(1)
            flags = dict(zip(TEMPLATE_PARAMS.get(name, ("qt",)),
                             (f == "1" for f in re.findall(r"Lb([01])E", m.group(2)))))
            name += ("_qt" if flags.get("qt") else "") + (
                "_relaxed" if flags.get("relaxed") else "")
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def profile_once(dz, x_np, cfg, blob, card, path) -> dict:
    """One compress and one decompress under torch.profiler: device busy
    time (kernels plus copies) against wall time, and the top activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in (("compress", lambda: dz.compress(x_np, config=cfg, device="cuda")),
                     ("decompress", lambda: dz.decompress(blob, device="cuda"))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side activities only (kernels, memcpys, memsets): the CPU
        # op rows of key_averages() also carry the device time they caused
        per: dict = {}
        for ev in prof.events():
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not ev.name.startswith("Activity Buffer")):
                ms, calls = per.get(ev.name, (0.0, 0))
                per[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, calls + 1)
        rows = sorted(((ms, k, c) for k, (ms, c) in per.items()), reverse=True)
        busy = sum(r[0] for r in rows)
        copies = sum(r[0] for r in rows if r[1].startswith(("Memcpy", "Memset")))
        out[name] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                     "kernel_ms": busy - copies, "copy_ms": copies,
                     "device_idle_share": 1.0 - busy / (wall * 1e3),
                     "top": [{"ms": r[0], "kernel": r[1][:80], "calls": r[2]} for r in rows[:8]]}
        emit("profile", card=card, path=path, op=name, **out[name])
    return out


def pipeline_trace(dz, x_np, cfg, blob, card, path, seg: int) -> dict:
    """One traced run of each direction of a DTZS path: the spans of the
    stream writer (pipeline.* on its thread, pack.pull and pack.host on its
    worker) and reader (pipeline.wait, pipeline.decode, copy_out; prep on
    its worker), from a StageTimer's spans, in ms from the call's start,
    with the thread each ran on, and the wall time."""
    import io

    import torch

    from dctz_tpu_torch import stream
    from dctz_tpu_torch.utils.timing import StageTimer

    xd = torch.from_numpy(x_np).to("cuda")  # as compress() hands it over
    out = {}
    for op in ("compress", "decompress"):
        timer = StageTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if op == "compress":
            stream.compress_stream(xd, io.BytesIO(), config=cfg,
                                   segment_elems=seg,
                                   timer=timer, device="cuda")
        else:
            stream.decompress_stream_all(stream.MemReader(blob), timer=timer,
                                         device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        spans = [{"span": s.name, "segment": s.index, "thread": s.thread,
                  "start_ms": (s.t0 - t0) * 1e3, "ms": (s.t1 - s.t0) * 1e3}
                 for s in timer.spans]
        out[op] = {"wall_ms": wall, "spans": spans, "counts": timer.counts}
        emit("pipeline_trace", card=card, path=path, op=op, wall_ms=wall,
             spans=spans, counts=timer.counts)
    return out


def profiled_kernel_ms(fn, symbol: str, reps: int) -> dict:
    """One kernel's own device time per call under torch.profiler, over
    `reps` calls of fn (after a warm-up), and all of fn's device time per
    call. A session that records none of the kernel's launches (the
    profiler drops a session's device records now and then) is run again,
    up to six sessions in all; None where none recorded them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 7):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.name.startswith("Activity Buffer")]
        mine = [ev.time_range.elapsed_us() for ev in evs
                if symbol.replace(" ", "") in ev.name.replace(" ", "")]
        if len(mine) == reps:
            break
    every = sum(ev.time_range.elapsed_us() for ev in evs)
    return {"profiler_kernel_ms": sum(mine) / 1e3 / len(mine) if mine else None,
            "profiler_device_ms_per_call": every / 1e3 / reps if evs else None,
            "profiler_launches": len(mine), "calls": reps, "sessions": attempt}


def dtzs_frames(blob: bytes) -> list:
    """The containers of a DTZS stream, in order (the stream layout of
    dctz_tpu_torch/stream.py), or [blob] for a single container."""
    import struct

    if blob[:4] != b"DTZS":
        return [blob]
    off, out = 16, []
    while True:
        (flen,) = struct.unpack_from("<Q", blob, off)
        off += 8
        if not flen:
            return out
        out.append(blob[off : off + flen])
        off += flen


def same_f64_container(a: bytes, b: bytes) -> tuple[bool, float | None]:
    """(whether two containers, or DTZS streams frame by frame, are the same
    but for the mean, the largest relative difference of their qtables):
    tests/test_parity_native.py's rules, every section and header field
    equal but the mean, a QT qtable within rtol 1e-15 (its maxima are of
    coefficients that differ by an ulp between two float64 transforms)."""
    import dataclasses

    import numpy as np

    from dctz_tpu_torch.core import container as ct

    def parse(f):
        if ct.detect_format(f) == "v1":
            h, *sec, q = ct.parse_v1(f)
            return dataclasses.replace(h, mean=0.0), tuple(sec), q
        h, sec, q, cb = ct.parse_v2(f)
        return dataclasses.replace(h, mean=0.0), sec + (cb,), q

    fa, fb = dtzs_frames(a), dtzs_frames(b)
    same, rel = len(fa) == len(fb), None
    for x, y in zip(fa, fb):
        (ha, sa, qa), (hb, sb, qb) = parse(x), parse(y)
        same = same and ha == hb and sa == sb and (qa is None) == (qb is None)
        if qa is not None and qb is not None:
            r = float(np.max(np.abs(qa - qb)
                             / np.maximum(np.abs(qb), np.finfo(np.float64).tiny)))
            rel = r if rel is None else max(rel, r)
            same = same and r <= 1e-15
    return same, rel


def ids_codec_of(header, fmt: str) -> str:
    """The coder that took a container's ids: zlib for v1, the device (DPK)
    coder, native rANS or deflate for v2."""
    if fmt == "v1":
        return "zlib (v1)"
    return "device" if header.dpk else "rans" if header.rans else "deflate"


def max_abs_diff(pairs) -> float:
    """Largest |a - b| over pairs of equal-shape tensors (any dtype)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: int, flops: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak (fp32 outside the tensor
    cores unless named)."""
    tb, tf = n_bytes / PEAK_BYTES, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def item9_checks(dz, api, path, pcfg, x, blob, y, heads, timer, ratio, e2e, launched,
                 tol, card) -> dict:
    """The end-to-end checks of an item-9 path beyond the common ones: the
    stored width (8-byte items for truncate=False float64, a header that
    says so in v2), the chosen brsf and each trial's size and the trials'
    share of the compress (rate="auto"), the ratio beside the same family
    at the default options, and the card against the CPU on a PREFIX-sample
    prefix of the input, as f64_card_vs_cpu holds them: the containers
    equal but for the mean (same_f64_container's rules), their sizes within
    RATIO_REL_TOL, the same brsf, each decoding the other's within the
    bound, and the card's and the CPU's decodes of the card's container
    equal byte for byte."""
    import numpy as np

    cfg = pcfg
    full = not cfg.truncate and x.dtype == np.float64
    widths = []
    for f in dtzs_frames(blob):
        host = api._host_stage(f)[2]
        dc = host[1] if len(host) == 3 else host[3]
        widths.append(4 if dc.dtype == np.uint8 else dc.dtype.itemsize)
    require(widths == [8 if full else 4] * len(widths),
            f"{path}: stored items of {widths} bytes")
    if full:
        require(all(h.truncate == (api.ct.detect_format(f) == "v1")
                    for h, f in zip(heads, dtzs_frames(blob))),
                f"{path}: a v2 header that does not say truncate=False")
    brsfs = sorted({h.brsf for h in heads})
    require(len(brsfs) == 1, f"{path}: frames of brsf {brsfs}")
    row = {"path": path, "card": card, "ratio": ratio, "stored_item_bytes": widths[0],
           "brsf": brsfs[0], "beside": ITEM9_BESIDE[path],
           "beside_ratio": e2e[ITEM9_BESIDE[path]]["ratio"],
           "ratio_rel_diff": ratio / e2e[ITEM9_BESIDE[path]]["ratio"] - 1.0,
           "compress_s": timer.total, "stages_s": dict(timer.stages)}
    if cfg.rate == "auto":
        row["trials"] = [{"brsf": b, "bytes": sz, "s": t} for b, sz, t in timer.rate_trials]
        row["trials_share_of_compress"] = timer.stages["rate"] / timer.total
        row["trial_launches"] = {k: v for k, v in timer.after_rate.items() if v}
        a_b = (("dct_quant_verify" if cfg.mode == "ec" else "dct_quant_verify_qt"),
               "dpk_pack_compact")
        require(all(timer.after_rate.get(k, 0) >= len(row["trials"]) for k in a_b),
                f"{path}: trials launched {row['trial_launches']}, not A and B each")
        require(row["trials"] and brsfs[0] in [t["brsf"] for t in row["trials"]],
                f"{path}: the chosen brsf was no trial's")
    emit("item9_path", **row)

    xs = x[:PREFIX]
    b_gpu = dz.compress(xs, config=cfg, device="cuda")
    b_cpu = dz.compress(xs, config=cfg, device="cpu")
    same = same_f64_container(b_gpu, b_cpu)[0]
    tol_s = cfg.error_bound * float(xs.max() - xs.min())
    y_gg = dz.decompress(b_gpu, device="cuda")
    y_cg = dz.decompress(b_gpu, device="cpu")
    e1 = float(np.abs(dz.decompress(b_cpu, device="cuda") - xs).max())
    e2 = float(np.abs(y_cg - xs).max())
    same_decode = y_gg.tobytes() == y_cg.tobytes()

    def brsf_of(b):
        f = dtzs_frames(b)[0]
        return (api.ct.parse_v1(f)[0] if api.ct.detect_format(f) == "v1"
                else api.ct.parse_v2(f)[0]).brsf

    cc = {"path": path, "n": int(xs.size), "containers_equal_but_mean": same,
          "brsf_card": brsf_of(b_gpu), "brsf_cpu": brsf_of(b_cpu),
          "ratio_rel_diff": len(b_cpu) / len(b_gpu) - 1.0,
          "gpu_decodes_plain_max_err": e1, "plain_decodes_gpu_max_err": e2,
          "decodes_bytes_equal": same_decode, "bound": tol_s}
    emit("item9_card_vs_cpu", **cc)
    require(same, f"{path}: the card's container differs from the CPU run's")
    require(abs(cc["ratio_rel_diff"]) <= RATIO_REL_TOL,
            f"{path}: ratio differs from the CPU run's")
    require(cc["brsf_card"] == cc["brsf_cpu"], f"{path}: card and CPU chose other brsf")
    require(e1 <= tol_s and e2 <= tol_s, f"{path}: cross decode violates the bound")
    require(same_decode, f"{path}: the card's and the CPU's decodes differ")
    return {"ratio": ratio, "launches": launched, "item9": row, "card_vs_cpu": cc,
            "evaluate": dz.evaluate(x, y, cfg.error_bound)}


#: the drivers phase's CLI runs on the bench array (32Mi float32) and the
#: CESM-length formula in float64: the options after the protocol's
#: positionals, the input, the API configuration whose container the .z
#: must equal (None: dz.compress(x) with no config), the kernels that must
#: launch at least once a frame on compress and on decode, and the kernels
#: that must not launch
DRIVER_RUNS = {
    "v1_ec": ([], "bench", None, ("dct_quant", "chunk_compact"),
              ("chunk_expand", "dequant_idct"), ()),
    "v2_dpk": (["--container", "v2", "--ids-codec", "device", "--verify"], "bench",
               dict(container="v2", ids_codec="device", verify=True),
               ("dct_quant_verify", "dpk_pack_compact"),
               ("dpk_unpack_expand", "dequant_idct"), ()),
    "v1_qt": (["--mode", "qt"], "bench", dict(mode="qt"),
              ("qtable_qmax", "dct_quant_qt", "chunk_compact"),
              ("chunk_expand", "dequant_idct_qt"), ()),
    "v1_f64_cesm": (["--verify"], "cesm64", dict(verify=True), ("chunk_compact",),
                    ("chunk_expand",), D_KERNELS),
}
#: the bounds of the msst19 sweep (the reference's tests/test-dctz.sh:15)
MSST19_BOUNDS = (1e-3, 1e-4, 1e-5)
#: the fields of a harness row that are clocks
ROW_SPEEDS = ("compress_mb_s", "decompress_mb_s")


def run_cli(dz, fk, argv: list) -> tuple:
    """dctz_tpu_torch.cli.main in this process, its stdout caught: (exit
    code, stdout lines, launches of its compress, launches of its
    decompress). The counters are reset first and read again where the CLI
    calls decompress (a wrapper around dz.decompress, which the CLI looks
    up at the call)."""
    import io

    from dctz_tpu_torch import cli

    at_decode: dict = {}
    api_decompress = dz.decompress

    def decompress(*a, **kw):
        at_decode.update(fk.LAUNCHES)
        return api_decompress(*a, **kw)

    out = io.StringIO()
    fk.reset_launches()
    dz.decompress = decompress
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    finally:
        dz.decompress = api_decompress
    total = dict(fk.LAUNCHES)
    return (rc, out.getvalue().splitlines(), dict(at_decode),
            {k: v - at_decode.get(k, 0) for k, v in total.items()})


def caught(fn, argv: list) -> tuple:
    """(exit code, stdout lines) of a tool's main(argv)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue().splitlines()


def drivers_phase(dz, fk, native, inputs: dict, dpk_blob: bytes, card: str) -> dict:
    """4d. The drivers and tools through their entry points on the card:
    the CLI's four runs (DRIVER_RUNS), the harness's msst19 and cesm-atm
    sweeps, dctz_dump's dump and extract, dct_test on 1Mi prefixes. Prints
    one line a surface and the phase's wall time."""
    import shutil
    import tempfile

    import numpy as np

    from dctz_tpu_torch.eval import harness
    from dctz_tpu_torch.eval.datasets import SUITES
    from dctz_tpu_torch.tools import dct_test, dctz_dump

    t_phase = time.perf_counter()
    out: dict = {"cli": {}, "harness": [], "dump": {}, "extract": {}, "dct_test": {}}
    os.makedirs("build", exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="drivers-", dir="build")
    try:
        files = {"bench": os.path.join(tmp, "bench.bin"),
                 "cesm64": os.path.join(tmp, "cesm64.bin")}
        for k, path in files.items():
            inputs[k].tofile(path)
        containers = {}
        for name, (opts, inp, kw, comp_k, dec_k, never) in DRIVER_RUNS.items():
            x = inputs[inp]
            head = (["-d", "1E-3", "CLDHGH", files[inp], "1800", "3600", "sol(1E-3)"]
                    if inp == "cesm64" else ["-f", "1E-3", "var", files[inp], str(x.size)])
            argv = head + opts + ["--json"]
            rc, lines, l_comp, l_dec = run_cli(dz, fk, argv)
            require(rc == 0, f"drivers: cli {name} exited {rc}")
            m = json.loads(next(ln for ln in lines if ln.startswith("{")))
            mode = "qt" if "qt" in opts else "ec"
            z_path = f"{files[inp]}.{mode}.1E-3.z"
            with open(z_path, "rb") as f:
                z = f.read()
            # each run's own name: v1_ec and v2_dpk write the same file name
            containers[name] = os.path.join(tmp, f"{name}.z")
            os.replace(z_path, containers[name])
            frames = len(dtzs_frames(z))
            # the API twin in the same process: the same container, its decode
            # the CLI's .z.r
            cfg_api = None if kw is None else dz.CodecConfig(**kw)
            t0 = time.perf_counter()
            z_api = dz.compress(x, config=cfg_api, device="cuda")
            t1 = time.perf_counter()
            y_api = dz.decompress(z, device="cuda")
            t2 = time.perf_counter()
            r = np.fromfile(z_path + ".r", x.dtype)
            row = {"run": name, "card": card, "argv": argv[:3] + ["<file>"] + argv[4:],
                   "n": int(x.size), "input_dtype": str(x.dtype), "frames": frames,
                   "bytes_out": len(z), "ratio": x.nbytes / len(z),
                   "compress_s": m["compress_s"], "decompress_s": m["decompress_s"],
                   "compress_gb_s": x.nbytes / m["compress_s"] / 1e9,
                   "decompress_gb_s": x.nbytes / m["decompress_s"] / 1e9,
                   "api_compress_s": t1 - t0, "api_decompress_s": t2 - t1,
                   "z_equals_api": z == z_api, "zr_equals_api_decode":
                   r.tobytes() == y_api.tobytes(),
                   "bound_satisfied": m["bound_satisfied"], "max_rel_err": m["max_rel_err"],
                   "launches_compress": {k: v for k, v in l_comp.items() if v},
                   "launches_decode": {k: v for k, v in l_dec.items() if v},
                   "stdout": [ln for ln in lines if not ln.startswith("{")]}
            emit("drivers_cli", **row)
            out["cli"][name] = row
            require(lines[0] == f"total number of elements = {x.size}" and lines[-1] == "done",
                    f"drivers: cli {name}: stdout {lines[:1]} ... {lines[-1:]}")
            require(row["z_equals_api"], f"drivers: cli {name}: .z differs from the API's")
            require(row["zr_equals_api_decode"],
                    f"drivers: cli {name}: .z.r differs from dz.decompress of the .z")
            require(y_api.dtype == x.dtype, f"drivers: cli {name}: decoded to {y_api.dtype}")
            require(m["bound_satisfied"], f"drivers: cli {name}: bound violated")
            short = [k for k in comp_k if l_comp[k] < frames] + [
                k for k in dec_k if l_dec[k] < frames]
            require(not short, f"drivers: cli {name}: fewer launches than frames: {short}")
            ran = [k for k in never if l_comp[k] or l_dec[k]]
            require(not ran, f"drivers: cli {name}: launched {ran}")
            os.remove(z_path + ".r")

        # the harness: msst19 (six float64 datasets; each torch row against
        # its CPU twin) and cesm-atm (five 1800x3600 float32 fields,
        # synthetic here; kernel H on every dctz row)
        launched_rows: list = []

        def progress(_line):
            launched_rows.append({k: v for k, v in fk.LAUNCHES.items() if v})
            fk.reset_launches()

        engines = ("torch", "native", "auto") if native.available() else ("torch", "auto")
        for suite, kw in (
                ("msst19", dict(bounds=MSST19_BOUNDS, modes=("ec", "qt"), engines=engines)),
                ("cesm-atm", dict(bounds=(1e-3,), modes=("ec", "qt"), engines=("torch",),
                                  sz_baseline=False))):
            launched_rows.clear()
            fk.reset_launches()
            t0 = time.perf_counter()
            rows = harness.sweep(suite, device="cuda", progress=progress, **kw)
            t_suite = time.perf_counter() - t0
            by_name = {d.name: d for d in SUITES[suite]}
            for row, launched in zip(rows, launched_rows):
                rec = dict(row, suite=suite, card=card, launches=launched)
                if suite == "msst19" and row["compressor"].endswith("_torch"):
                    mode = row["compressor"].split("_")[1]
                    twin = harness.run_one(by_name[row["dataset"]], row["error_bound"], mode,
                                           device="cpu")
                    rec["equals_cpu_row"] = all(twin[k] == row[k] for k in row
                                                if k not in ROW_SPEEDS)
                    require(rec["equals_cpu_row"],
                            f"drivers: {row['dataset']} {row['compressor']} "
                            f"{row['error_bound']}: differs from the CPU row {twin}")
                emit("drivers_harness", **rec)
                out["harness"].append(rec)
                if row["compressor"].startswith("dctz_"):
                    require(row["bound_satisfied"],
                            f"drivers: {row['dataset']} {row['compressor']}: bound violated")
                    if suite == "cesm-atm":
                        require(launched.get("chunk_compact", 0) > 0,
                                f"drivers: {row['dataset']} {row['compressor']}: no H")
            emit("drivers_sweep", card=card, suite=suite, rows=len(rows), seconds=t_suite,
                 engines=list(kw["engines"]))
            out[f"{suite}_seconds"] = t_suite

        # dctz_dump: dump on the CLI's containers and on phase 4's monolithic
        # DPK container; extract on the DPK one and the v1 EC one, the card's
        # files byte-equal to the CPU's
        containers["ec_dpk"] = os.path.join(tmp, "ec_dpk.z")
        with open(containers["ec_dpk"], "wb") as f:
            f.write(dpk_blob)
        for name, path in containers.items():
            info = dctz_dump.dump(path)
            out["dump"][name] = info
            # a DTZS stream's dict: its total and its frames' headers
            frames = info.get("frames", [info])
            emit("drivers_dump", card=card, container=name, format=info["format"],
                 elements=info.get("num_elements", info.get("total_elements")),
                 total_bytes=info["total_bytes"], frames=len(frames),
                 modes=sorted({f["mode"] for f in frames}),
                 dpk=[f["dpk"] if "dpk" in f else f["filters"]["dpk"] for f in frames])
            require(info.get("num_elements", info.get("total_elements")) == (
                inputs["cesm64"] if name == "v1_f64_cesm" else inputs["bench"]).size,
                f"drivers: dump {name}: {info}")
        for name in ("ec_dpk", "v1_ec"):
            fk.reset_launches()
            t0 = time.perf_counter()
            got = dctz_dump.extract(containers[name], os.path.join(tmp, "card"), device="cuda")
            t_card = time.perf_counter() - t0
            launched = {k: v for k, v in fk.LAUNCHES.items() if v}
            want = dctz_dump.extract(containers[name], os.path.join(tmp, "cpu"), device="cpu")
            same = {}
            for a, b in zip(got, want):
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    same[os.path.basename(a).split(".", 1)[1]] = fa.read() == fb.read()
                os.remove(a)
                os.remove(b)
            row = {"container": name, "card": card, "files": len(got), "equal": same,
                   "card_s": t_card, "launches": launched}
            emit("drivers_extract", **row)
            out["extract"][name] = row
            require(len(got) == len(want) and all(same.values()),
                    f"drivers: extract {name}: the card's files differ from the CPU's {same}")
            # the DPK id stream's exception bytes expand on kernel I; a v1
            # container's streams are host code on either device
            require(launched == ({"chunk_expand": 1} if name == "ec_dpk" else {}),
                    f"drivers: extract {name}: launched {launched}")

        # dct_test on 1Mi prefixes: the bench array (float32) and the
        # CESM-length formula in float64; max_diff and the scipy oracle's
        # within 32 eps of max |x|, the .x and .r within 32 eps of each
        # block's max |x| of the CPU run's
        for label, arr, flag in (("bench_f32", inputs["bench"][:PREFIX], "-f"),
                                 ("cesm_f64", inputs["cesm64"][:PREFIX], "-d")):
            paths = {d: os.path.join(tmp, f"{label}_{d}.bin") for d in ("cuda", "cpu")}
            printed = {}
            for d, path in paths.items():
                arr.tofile(path)
                rc, lines = caught(dct_test.main, [flag, path, str(arr.size)]
                                   + (["--device", "cpu"] if d == "cpu" else []))
                require(rc == 0 and len(lines) == 3, f"drivers: dct_test {label} {d}: {lines}")
                printed[d] = [float(ln.split(":" if i == 0 else "=")[1])
                              for i, ln in enumerate(lines)]
            eps = float(np.finfo(arr.dtype).eps)
            lim = 32 * eps * float(np.abs(arr).max())
            blocks = np.concatenate([arr, np.zeros(-arr.size % 64, arr.dtype)]).reshape(-1, 64)
            budget = np.repeat(32 * eps * np.abs(blocks).max(axis=1), 64)[:arr.size]
            worst = {}
            for ext in (".x", ".r"):
                a = np.fromfile(paths["cuda"] + ext, arr.dtype).astype(np.float64)
                b = np.fromfile(paths["cpu"] + ext, arr.dtype).astype(np.float64)
                worst[ext] = float(np.max(np.abs(a - b) / budget))
            row = {"input": label, "card": card, "n": int(arr.size), "dtype": str(arr.dtype),
                   "outliers": int(printed["cuda"][0]), "max_diff": printed["cuda"][1],
                   "oracle_max_diff": printed["cuda"][2], "cpu": printed["cpu"],
                   "eps_max_abs": eps * float(np.abs(arr).max()), "limit_32ulp": lim,
                   "card_vs_cpu_in_budget": worst}
            emit("drivers_dct_test", **row)
            out["dct_test"][label] = row
            require(row["max_diff"] <= lim and row["oracle_max_diff"] <= lim,
                    f"drivers: dct_test {label}: beyond 32 eps of max|x|: {row}")
            require(max(worst.values()) <= 1.0,
                    f"drivers: dct_test {label}: card and CPU .x/.r beyond the budget {worst}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit("drivers", card=card, seconds=out["seconds"],
         msst19_seconds=out["msst19_seconds"], cesm_atm_seconds=out["cesm-atm_seconds"])
    return out


#: tests/test_torch_oracle.py's MEAN_ULPS (that module imports jax): the
#: headers' float32 means of one array, summed in two orders, agree within
#: this many ulp of float32(mean |x|)
MEAN_ULPS = 4
#: the sharded phase's mesh on the one card: this many shards of cuda:0
SHARDS = 4
#: the two-rank run of the sharded phase: ranks, and each rank's timeout
RANKS = 2
RANK_TIMEOUT_S = 300


def compare_v2(a: bytes, b: bytes, x) -> dict:
    """How two v2 containers of the same array compare: every section
    equal, every header field but the mean equal, the qtables equal (and
    equal but for slot 0, the last blocks' DC, which the decoder never
    reads), and the means' difference in ulp of float32(mean |x|)."""
    import dataclasses

    import numpy as np

    from dctz_tpu_torch.core import container as ct

    (ha, sa, qa, _), (hb, sb, qb, _) = ct.parse_v2(a), ct.parse_v2(b)
    ulp = float(np.spacing(np.float32(np.abs(x).mean())))
    same_q = (qa is None) == (qb is None) and (qa is None or qa.tobytes() == qb.tobytes())
    return {"sections_equal": sa == sb,
            "header_equal_but_mean": (dataclasses.replace(ha, mean=0.0)
                                      == dataclasses.replace(hb, mean=0.0)),
            "qtable_equal": same_q,
            "qtable_equal_but_slot0": same_q or (
                qa is not None and qb is not None and qa[1:].tobytes() == qb[1:].tobytes()),
            "mean_ulps": abs(ha.mean - hb.mean) / ulp}


def rank_main(args) -> int:
    """One rank of a multi-rank run (chip_smoke.py --rank R --world W
    --port P --n N --work DIR --backend B, started by run_ranks): a
    process group on 127.0.0.1 (gloo for ranks that share a card, which
    NCCL refuses; NCCL for one rank a card), the rank's mesh its card. compress_multihost of its slice of the bench
    formula at N samples, 1 + REPS times between barriers (the wall time
    of each write); its part to DIR/part{R}.bin; then decompress_multihost
    of the concatenated parts and of DIR/mono.bin (a monolithic DPK
    container: the tile-range decode); each run's launch counts. Writes
    DIR/rank{R}.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import dctz_tpu_torch as dz
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import idpack
    from dctz_tpu_torch.parallel import multihost as mh
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    torch.backends.cuda.matmul.allow_tf32 = False
    mh.init(f"tcp://127.0.0.1:{args.port}", args.world, args.rank, backend=args.backend)
    work, n = args.work, args.n
    cfg = dz.CodecConfig(**dict(DPK, mode="ec", segment_elems=0))
    lo, hi = mh.host_slice(n, quantum_blocks=idpack.B_DEFAULT)
    local = climate_formula_np(n)[lo:min(hi, n)]
    times, launches = [], {}
    for rep in range(1 + REPS):
        fk.reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        part = mh.compress_multihost(local, n, config=cfg)
        dist.barrier()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches["write"] = dict(fk.LAUNCHES)
    with open(os.path.join(work, f"part{args.rank}.bin"), "wb") as f:
        f.write(part)
    dist.barrier()
    stream = b"".join(open(os.path.join(work, f"part{r}.bin"), "rb").read()
                      for r in range(args.world))
    fk.reset_launches()
    res = mh.decompress_multihost(stream)
    launches["restore"] = dict(fk.LAUNCHES)
    fk.reset_launches()
    mono = mh.decompress_multihost(open(os.path.join(work, "mono.bin"), "rb").read())
    launches["restore_mono"] = dict(fk.LAUNCHES)
    np.savez(os.path.join(work, f"rank{args.rank}.npz"), data=res.data, start=res.start,
             frames=np.asarray(res.frames, np.int64), mono=mono.data,
             mono_start=mono.start, write_s=np.asarray(times),
             launches=np.asarray(json.dumps(launches)))
    dist.destroy_process_group()
    return 0


def run_ranks(dz, n_ranks: int, backend: str, mono_blob: bytes, y_mono, card: str) -> dict:
    """Spawns n_ranks ranks of this script (rank_main) on `backend`, each
    with a timeout, a failure in any failing the run: compress_multihost
    over N + 7 samples of the bench formula, the concatenated parts
    decoded within the bound, decompress_multihost giving each rank its
    own frame, equal to the full decode's slice, and the tile-range
    restore of mono_blob (the monolithic ec container) equal to y_mono's
    slices; A, B, C and D launched in every rank. Prints one
    "sharded_ranks" line."""
    import shutil
    import socket

    import numpy as np

    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    work = os.path.join("build", f"ranks_{backend}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "mono.bin"), "wb") as f:
        f.write(mono_blob)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n7 = N + 7
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(n_ranks),
         "--port", str(port), "--n", str(n7), "--work", work, "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(n_ranks)]
    try:
        for r, p in enumerate(procs):
            _o, err = p.communicate(timeout=RANK_TIMEOUT_S)
            require(p.returncode == 0,
                    f"ranks: rank {r} exited {p.returncode}: {err.decode()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    stream = b"".join(open(os.path.join(work, f"part{r}.bin"), "rb").read()
                      for r in range(n_ranks))
    x7 = climate_formula_np(n7)
    y7 = dz.decompress(stream, device="cuda")
    err7 = float(np.abs(y7 - x7).max())
    tol7 = DPK["error_bound"] * float(x7.max() - x7.min())
    ranks = []
    for r in range(n_ranks):
        z = np.load(os.path.join(work, f"rank{r}.npz"))
        st, data, mst, mdata = int(z["start"]), z["data"], int(z["mono_start"]), z["mono"]
        launches = json.loads(str(z["launches"]))
        ranks.append({"rank": r, "start": st, "n": int(data.size),
                      "frames": z["frames"].tolist(), "mono_start": mst,
                      "mono_n": int(mdata.size),
                      "slice_equal": data.tobytes() == y7[st : st + data.size].tobytes(),
                      "mono_slice_equal": mdata.tobytes() == y_mono[mst : mst + mdata.size].tobytes(),
                      "write_s": z["write_s"].tolist(),
                      "launches": {k: {kk: v for kk, v in d.items() if v}
                                   for k, d in launches.items()}})
    write_s = statistics.median(max(rk["write_s"][i] for rk in ranks)
                                for i in range(1, 1 + REPS))
    mr = {"ranks": n_ranks, "backend": backend, "n": n7, "bytes_out": len(stream),
          "ratio": x7.nbytes / len(stream), "max_err": err7, "bound": tol7,
          "write_wall_s": write_s, "write_gb_s": x7.nbytes / write_s / 1e9,
          "spawn_to_exit_s": ranks_s, "per_rank": ranks}
    emit("sharded_ranks", card=card, **mr)
    require(err7 <= tol7, "ranks: the ranks' stream violates the bound")
    require(sum(rk["n"] for rk in ranks) == n7 and sum(rk["mono_n"] for rk in ranks) == N,
            "ranks: the ranks' restores do not cover the array")
    for rk in ranks:
        require(rk["slice_equal"] and rk["mono_slice_equal"],
                f"ranks: rank {rk['rank']}'s restore differs from the full decode")
        w, rs, rm = (rk["launches"][k] for k in ("write", "restore", "restore_mono"))
        require(w.get("dct_quant_verify") and w.get("dpk_pack_compact"),
                f"ranks: rank {rk['rank']}'s write launched {w}")
        require(rs.get("dpk_unpack_expand") and rs.get("dequant_idct")
                and rm.get("dpk_unpack_expand") and rm.get("dequant_idct"),
                f"ranks: rank {rk['rank']}'s restores launched {rs}, {rm}")
        require(rk["frames"] == [rk["rank"]],
                f"ranks: rank {rk['rank']} decoded frames {rk['frames']}")
    shutil.rmtree(work, ignore_errors=True)
    return mr


def multi_card_phase(dz, fk, card: str) -> dict:
    """chip_smoke.py --multi-card, on a machine with two or more cards:
    compress_sharded / decompress_sharded over sharding.make_mesh() (every
    card) on the bench array, EC (each container the single-card
    monolithic container but for the mean, A and B once a card, C and D
    once a card, the decode equal to decompress's) and QT on the x30
    input (the ratio within 0.1% of the single-card container's); times
    beside the single-card mesh and the monolithic path; then one NCCL
    rank a card (run_ranks). Prints one line a check."""
    import numpy as np
    import torch

    from dctz_tpu_torch.parallel import sharding as sh
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

    mesh = sh.make_mesh()
    k = len(mesh)
    require(k >= 2, f"--multi-card: {k} card(s) visible")
    x = climate_formula_np(N)
    x30 = x.copy()
    x30[::977] *= np.float32(30.0)
    out: dict = {"cards": k}
    for mode, xin in (("ec", x), ("qt", x30)):
        cfg = dz.CodecConfig(**dict(DPK, mode=mode, segment_elems=0))
        mono = dz.compress(xin, config=cfg, device="cuda:0")
        fk.reset_launches()
        blob = dz.compress_sharded(xin, config=cfg, mesh=mesh)
        enc = {kk: v for kk, v in fk.LAUNCHES.items() if v}
        fk.reset_launches()
        y = dz.decompress_sharded(blob, mesh=mesh)
        dec = {kk: v for kk, v in fk.LAUNCHES.items() if v}
        row = {"mode": mode, "cards": k, "ratio": xin.nbytes / len(blob),
               "single_card_ratio": xin.nbytes / len(mono), **compare_v2(blob, mono, xin),
               "encode_launches": enc, "decode_launches": dec,
               "max_err": float(np.abs(y - xin).max()),
               "bound": DPK["error_bound"] * float(xin.max() - xin.min()),
               "decode_equals_decompress":
                   y.tobytes() == dz.decompress(blob, device="cuda:0").tobytes()}
        emit("multi_card", card=card, **row)
        out[mode] = row
        require(row["max_err"] <= row["bound"] and row["decode_equals_decompress"],
                f"multi_card {mode}: the decode is out of bound or differs from decompress")
        require(abs(row["ratio"] / row["single_card_ratio"] - 1.0) <= RATIO_REL_TOL,
                f"multi_card {mode}: the ratio differs from the single card's")
        if mode == "ec":
            require(row["sections_equal"] and row["header_equal_but_mean"]
                    and row["mean_ulps"] <= MEAN_ULPS,
                    "multi_card ec: the container differs from the single card's")
            require(enc.get("dct_quant_verify", 0) % k == 0 and enc.get("dpk_pack_compact")
                    == enc.get("dct_quant_verify") and dec == {
                        "dpk_unpack_expand": k, "dequant_idct": k},
                    f"multi_card ec: launches {enc}, {dec}")
            blob_ec, mono_ec = blob, mono
    cfg = dz.CodecConfig(**dict(DPK, mode="ec", segment_elems=0))
    fns = {"ec_compress": lambda: dz.compress(x, config=cfg, device="cuda:0"),
           "ec_decompress": lambda: dz.decompress(mono_ec, device="cuda:0")}
    for label, m in (("mesh1", mesh[:1]), (f"x{k}", mesh)):
        fns[f"sharded_{label}_compress"] = lambda m=m: dz.compress_sharded(x, config=cfg, mesh=m)
        fns[f"sharded_{label}_decompress"] = lambda m=m: dz.decompress_sharded(blob_ec, mesh=m)
    out["times"] = {}
    for label, fn in fns.items():
        t = wall_s(fn, REPS)
        out["times"][label] = {"s": t, "gb_s": x.nbytes / t / 1e9}
    emit("multi_card_times", card=card, cards=k, n=N, reps=REPS, times=out["times"])
    torch.cuda.synchronize()
    out["ranks"] = run_ranks(dz, k, "nccl", mono_ec, dz.decompress(mono_ec, device="cuda:0"),
                             card)
    return out


def sharded_phase(dz, fk, inputs: dict, blobs: dict, decoded: dict, card: str) -> dict:
    """4e. Multi-GPU (ROADMAP item 10) on the one card: compress_sharded /
    decompress_sharded over sharding.make_mesh() and over SHARDS shards of
    cuda:0, multi-rank writes and restores over torch.distributed (gloo),
    and their times. Prints one line a check and the phase's wall time."""
    import numpy as np
    import torch

    from dctz_tpu_torch.parallel import sharding as sh

    t_phase = time.perf_counter()
    out: dict = {"runs": {}}
    x, x30 = inputs["bench"], inputs["x30"]
    tol = DPK["error_bound"] * float(x.max() - x.min())
    tol30 = DPK["error_bound"] * float(x30.max() - x30.min())
    ec_cfg = dz.CodecConfig(**dict(DPK, mode="ec", segment_elems=0))
    mesh1, mesh4 = sh.make_mesh(), ["cuda:0"] * SHARDS

    def run(name, xin, cfg, mesh, bound, twin, **extra):
        k = len(mesh)
        fk.reset_launches()
        blob = dz.compress_sharded(xin, config=cfg, mesh=mesh)
        enc = {kk: v for kk, v in fk.LAUNCHES.items() if v}
        fk.reset_launches()
        y = dz.decompress_sharded(blob, mesh=mesh)
        dec = {kk: v for kk, v in fk.LAUNCHES.items() if v}
        y_one = dz.decompress(blob, device="cuda")
        row = {"path": name, "shards": k, "n": int(xin.size), "bytes_out": len(blob),
               "ratio": xin.nbytes / len(blob), "encode_launches": enc,
               "decode_launches": dec, "max_err": float(np.abs(y - xin).max()),
               "bound": bound, "decode_equals_decompress": y.tobytes() == y_one.tobytes()}
        if twin is not None:
            row.update(twin=twin, twin_ratio=xin.nbytes / len(blobs[twin]),
                       **compare_v2(blob, blobs[twin], xin))
            row["ratio_rel_diff"] = row["ratio"] / row["twin_ratio"] - 1.0
        row.update(extra)
        emit("sharded", card=card, **row)
        out["runs"][name] = row
        require(row["max_err"] <= bound, f"sharded {name}: pointwise bound violated")
        require(row["decode_equals_decompress"],
                f"sharded {name}: decompress_sharded differs from decompress")
        return blob, row

    # EC, bench.py's configuration: the card's own mesh and SHARDS shards of
    # it, each container the monolithic ec container but for the mean
    for name, mesh in (("ec_mesh", mesh1), ("ec_x4", mesh4)):
        blob, row = run(name, x, ec_cfg, mesh, tol, "ec")
        k = len(mesh)
        enc, dec = row["encode_launches"], row["decode_launches"]
        retries = enc.get("dct_quant_verify", 0) // k - 1
        row["full_width_retries"] = retries
        emit("sharded_retries", card=card, path=name, full_width_retries=retries)
        require(row["sections_equal"] and row["header_equal_but_mean"] and row["qtable_equal"],
                f"sharded {name}: the container differs from the monolithic ec container")
        require(row["mean_ulps"] <= MEAN_ULPS, f"sharded {name}: mean {row['mean_ulps']} ulp off")
        require(set(enc) == {"dct_quant_verify", "dpk_pack_compact"}
                and enc["dct_quant_verify"] == enc["dpk_pack_compact"] == k * (1 + retries),
                f"sharded {name}: encode launches {enc}, not A and B once a shard")
        require(set(dec) == {"dpk_unpack_expand", "dequant_idct"}
                and dec["dpk_unpack_expand"] == dec["dequant_idct"] == k,
                f"sharded {name}: decode launches {dec}, not C and D once a shard")
        if name == "ec_x4":
            blob_x4 = blob

    # QT on the x30 input: the chain body (kernel H per shard), C and D-QT
    # on decode; the ratio beside qt_x30's (A-QT's), and whether the
    # sections are that container's, for the record
    qt_cfg = dz.CodecConfig(**dict(DPK, mode="qt", segment_elems=0))
    _b, row = run("qt_x30_x4", x30, qt_cfg, mesh4, tol30, "qt_x30")
    enc, dec = row["encode_launches"], row["decode_launches"]
    require(abs(row["ratio_rel_diff"]) <= RATIO_REL_TOL,
            f"sharded qt_x30_x4: ratio {row['ratio_rel_diff']:+.2e} off qt_x30's")
    require(enc.get("chunk_compact", 0) >= SHARDS and not enc.get("dct_quant_verify_qt"),
            f"sharded qt_x30_x4: encode launches {enc}: not the chain's H")
    require(dec.get("dpk_unpack_expand") == SHARDS and dec.get("dequant_idct_qt") == SHARDS,
            f"sharded qt_x30_x4: decode launches {dec}, not C and D-QT once a shard")

    # host-coded ids (deflate): H on encode, I and D on decode
    dfl_cfg = dz.CodecConfig(error_bound=DPK["error_bound"], container="v2",
                             ids_codec="deflate", segment_elems=0, verify=True)
    _b, row = run("v2_deflate_x4", x, dfl_cfg, mesh4, tol, None,
                  twin_ratio=x.nbytes / len(blobs["v2_deflate"]))
    enc, dec = row["encode_launches"], row["decode_launches"]
    require(enc.get("chunk_compact", 0) >= SHARDS,
            f"sharded v2_deflate_x4: encode launches {enc}: H not once a shard")
    require(dec.get("chunk_expand") == SHARDS and dec.get("dequant_idct") == SHARDS,
            f"sharded v2_deflate_x4: decode launches {dec}, not I and D once a shard")

    # a length whose last shard carries the padding
    x_pad = x[: N - 12345]
    run("ec_pad_x4", x_pad, ec_cfg, mesh4,
        DPK["error_bound"] * float(x_pad.max() - x_pad.min()), None)

    # a CUDA tensor: padded and split on the card (Tensor.cpu, .numpy,
    # .tolist and .to a host device raise meanwhile), the numpy input's bytes
    x_dev = torch.from_numpy(x).cuda()
    guarded = ("cpu", "numpy", "tolist", "to")
    saved = {k: getattr(torch.Tensor, k) for k in guarded}
    own = {k for k in guarded if k in vars(torch.Tensor)}

    def no_host(*_a, **_k):
        raise AssertionError("shard_input_device made a host copy")

    def to_guarded(t, *a, **kw):
        dst = kw.get("device", a[0] if a else None)
        if isinstance(dst, (str, torch.device)) and torch.device(dst).type == "cpu":
            no_host()
        return saved["to"](t, *a, **kw)

    try:
        for k in ("cpu", "numpy", "tolist"):
            setattr(torch.Tensor, k, no_host)
        torch.Tensor.to = to_guarded
        shards, n_pad = sh.shard_input_device(x_dev, sh.make_mesh(mesh4), 64, 256)
    finally:
        for k, v in saved.items():
            if k in own:
                setattr(torch.Tensor, k, v)
            else:
                delattr(torch.Tensor, k)
    require(n_pad == N and all(s.is_cuda and s.numel() == N // SHARDS for s in shards),
            "sharded: shard_input_device's shards are not on the card")
    same_dev = dz.compress_sharded(x_dev, config=ec_cfg, mesh=mesh4) == blob_x4
    emit("sharded_device_input", card=card, shards=SHARDS, bytes_equal_numpy_input=same_dev,
         host_copy=False)
    require(same_dev, "sharded: a CUDA tensor's container differs from the numpy input's")
    del x_dev, shards

    # times (median of REPS warm runs): the sharded entry points at 1 and
    # SHARDS shards beside the monolithic ec path, in this phase
    fns = {"ec_compress": lambda: dz.compress(x, config=ec_cfg, device="cuda"),
           "ec_decompress": lambda: dz.decompress(blobs["ec"], device="cuda")}
    for label, mesh in (("mesh1", mesh1), (f"x{SHARDS}", mesh4)):
        fns[f"sharded_{label}_compress"] = (
            lambda mesh=mesh: dz.compress_sharded(x, config=ec_cfg, mesh=mesh))
        fns[f"sharded_{label}_decompress"] = (
            lambda mesh=mesh: dz.decompress_sharded(blob_x4, mesh=mesh))
    out["times"] = {}
    for label, fn in fns.items():
        t = wall_s(fn, REPS)
        out["times"][label] = {"s": t, "gb_s": x.nbytes / t / 1e9}
    emit("sharded_times", card=card, n=N, reps=REPS, times=out["times"])

    # two ranks on the one card (gloo), spawned: the write over N + 7
    # samples, the restore of the concatenated parts, and the tile-range
    # restore of the monolithic ec container
    out["ranks"] = run_ranks(dz, RANKS, "gloo", blobs["ec"], decoded["ec"], card)
    out["seconds"] = time.perf_counter() - t_phase
    emit("sharded_phase", card=card, seconds=out["seconds"])
    return out


#: the suites phase's yardsticks: the committed reference CSVs (the JAX
#: package's eval/run_suites.sh on the CPU), by the sweep they hold
SUITE_REFS = {"randgen": "eval/results_randgen.csv",
              "spectral": "eval/results_spectral.csv",
              "spectral_psnr": "eval/results_spectral_psnr_matched.csv"}
#: a reference-held row's PSNR against the reference row's, in dB (the
#: ratio is held to RATIO_REL_TOL, PERF.md section 2's limit)
PSNR_TOL_DB = 0.01
#: the matched-PSNR curve's one point the suites phase runs
PSNR_POINT = 3e-3
#: the compressors held to the committed reference rows (the others, the
#: "auto" and "sharded" engines, are held to their CPU twins)
REFERENCE_HELD = ("_torch", "_native", "sz_like", "zlib")


def reference_rows(name: str) -> dict:
    """A committed reference CSV's rows by (compressor, dataset,
    error_bound), the compressor's "_jax" named "_torch"."""
    import csv

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), SUITE_REFS[name])
    with open(path, newline="") as f:
        return {(r["compressor"].replace("_jax", "_torch"), r["dataset"],
                 float(r["error_bound"])): r for r in csv.DictReader(f)}


def against_reference(row: dict, ref: dict) -> dict:
    """A card row beside its reference row: the ratio's relative
    difference, the PSNR's difference in dB (0 where both are infinite)
    and whether both satisfy the bound alike."""
    want = ref[(row["compressor"], row["dataset"], row["error_bound"])]
    p_want = float(want["psnr_db"])
    psnr_diff = (0.0 if p_want == row["psnr_db"] == float("inf")
                 else abs(row["psnr_db"] - p_want))
    return {"ratio_rel_diff": row["ratio"] / float(want["ratio"]) - 1.0,
            "psnr_diff_db": psnr_diff,
            "bound_equal": row["bound_satisfied"] == (want["bound_satisfied"] == "True"),
            "reference_ratio": float(want["ratio"])}


def suites_phase(dz, fk, native, card: str) -> dict:
    """4f. The evaluation sweeps of eval/run_suites_torch.sh that phase 4d
    leaves off the card, cut to a phase: randgen (EC at the
    three bounds; torch, native where it builds, auto), spectral at 1e-3
    (EC and QT; torch, auto), the sharded engine on randgen, and one point
    of the matched-PSNR curve of spectral (PSNR_POINT). The torch, native,
    sz_like and zlib rows are held to the committed reference CSVs
    (SUITE_REFS): the ratio within RATIO_REL_TOL, the PSNR within
    PSNR_TOL_DB, bound_satisfied alike. The auto and sharded rows are held
    to their CPU twins (harness.run_one(..., device="cpu")) in every column
    but the speeds, NOT to the committed CSVs: those were written on the
    CPU, where the reference resolves ids_codec="auto" to its host coders
    (dctz_tpu/api.py:1742-1755), while the port takes its accelerator's
    rule, DPK, on every device, so their containers differ by design.
    Kernel launches are recorded per row, split at the decode: H on every
    float32 torch row's compress, a kernel on every float32 auto row's
    compress and decode. Prints one line a row and one a sweep."""
    from dctz_tpu_torch.eval import harness
    from dctz_tpu_torch.eval.datasets import SUITES

    t_phase = time.perf_counter()
    out: dict = {"rows": [], "seconds": {}}
    refs = {k: reference_rows(k) for k in SUITE_REFS}
    by_name = {d.name: d for suite in ("randgen", "spectral") for d in SUITES[suite]}
    engines = ("torch", "native", "auto") if native.available() else ("torch", "auto")
    sweeps = (
        ("randgen", "randgen", lambda progress: harness.sweep(
            "randgen", modes=("ec",), engines=engines, device="cuda", progress=progress)),
        ("spectral", "spectral", lambda progress: harness.sweep(
            "spectral", bounds=(1e-3,), modes=("ec", "qt"), engines=("torch", "auto"),
            device="cuda", progress=progress)),
        ("randgen_sharded", None, lambda progress: harness.sweep(
            "randgen", modes=("ec",), engines=("sharded",), lossless=(), sz_baseline=False,
            device="cuda", progress=progress)),
        ("spectral_psnr", "spectral_psnr", lambda progress: harness.psnr_curve(
            "spectral", bounds=(PSNR_POINT,), device="cuda", progress=progress)),
    )
    at_decode: dict = {}
    launched: list = []

    def snapping(fn):
        def call(*a, **kw):
            at_decode.update(fk.LAUNCHES)
            return fn(*a, **kw)
        return call

    def progress(_line):
        total = dict(fk.LAUNCHES)
        comp = {k: v for k, v in (at_decode or total).items() if v}
        dec = {k: v - at_decode[k] for k, v in total.items() if at_decode and v > at_decode[k]}
        launched.append((comp, dec))
        at_decode.clear()
        fk.reset_launches()

    for sweep_name, ref_name, run in sweeps:
        launched.clear()
        api = (dz.decompress, dz.decompress_sharded)
        dz.decompress, dz.decompress_sharded = (snapping(f) for f in api)
        fk.reset_launches()
        t0 = time.perf_counter()
        try:
            rows = run(progress)
        finally:
            dz.decompress, dz.decompress_sharded = api
        t_sweep = time.perf_counter() - t0
        for row, (comp, dec) in zip(rows, launched):
            name = row["compressor"]
            rec = dict(row, sweep=sweep_name, card=card, launches_compress=comp,
                       launches_decode=dec)
            if ref_name and name.endswith(REFERENCE_HELD):
                rec["held_to"] = "reference"
                rec.update(against_reference(row, refs[ref_name]))
                ok = (abs(rec["ratio_rel_diff"]) <= RATIO_REL_TOL
                      and rec["psnr_diff_db"] <= PSNR_TOL_DB and rec["bound_equal"])
            else:
                rec["held_to"] = "cpu_twin"
                engine = name.rsplit("_", 1)[1]
                mode = name.split("_")[1]
                twin = harness.run_one(by_name[row["dataset"]], row["error_bound"], mode,
                                       engine, device="cpu")
                if "bits_per_value" in row:
                    twin["bits_per_value"] = round(
                        (64 if twin["dtype"] == "f64" else 32) / twin["ratio"], 4)
                rec["differs_from_cpu"] = sorted(k for k in row if k not in ROW_SPEEDS
                                                 and twin[k] != row[k])
                ok = not rec["differs_from_cpu"]
            emit("suites_row", **rec)
            out["rows"].append(rec)
            shown = ("ratio", "psnr_db", "ratio_rel_diff", "psnr_diff_db", "bound_equal",
                     "differs_from_cpu")
            require(ok, f"suites: {sweep_name} {row['dataset']} {name} {row['error_bound']}: "
                        f"{ {k: rec[k] for k in shown if k in rec} }")
            if name.startswith("dctz_"):
                require(row["bound_satisfied"], f"suites: {row['dataset']} {name}: bound violated")
                if row["dtype"] == "f32" and name.endswith("_torch"):
                    require(comp.get("chunk_compact", 0) > 0, f"suites: {row['dataset']} {name}: no H")
                if row["dtype"] == "f32" and name.endswith("_auto"):
                    require(comp and dec, f"suites: {row['dataset']} {name}: no kernel on "
                                          f"compress {comp} or decode {dec}")
        require(len(rows) == len(launched), f"suites: {sweep_name}: {len(launched)} launch "
                                            f"records for {len(rows)} rows")
        emit("suites_sweep", card=card, sweep=sweep_name, rows=len(rows), seconds=t_sweep,
             kernels=sorted({k for c, d in launched for k in (*c, *d)}))
        out["seconds"][sweep_name] = t_sweep
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    emit("suites", card=card, seconds=out["seconds"]["phase"], rows=len(out["rows"]))
    return out


#: the robustness phase's flipped positions (XOR 0x5A, seeded) per
#: container of phase 4: the monolithic DPK bench container (a quarter of
#: them in its first ROBUST_HEAD bytes: the fixed header, chunk tables and
#: crcs), the host-coded v2 one, the DPK DTZS stream and the v1 one (whose
#: flips each inflate up to the corrupted block)
ROBUST_FLIPS = {"ec": 256, "v2_deflate": 64, "ec_dtzs": 64, "v1_ec": 32}
ROBUST_HEAD = 4096
#: the v1 header's bytes that no check covers (dtype tag, element count,
#: error bound, padding, scaling factor, mean, the unused tail field): a
#: flip there decodes, in the JAX package and the C codec too
V1_UNCHECKED = frozenset(range(0, 16)) | frozenset(range(20, 40)) | frozenset(range(52, 56))
#: the decode kernels a corrupted container must not reach: C, D, D-QT, I
DECODE_KERNELS = ("dpk_unpack_expand", "dequant_idct", "dequant_idct_qt", "chunk_expand")


def frames_intact_before(blob: bytes, pos: int) -> int:
    """The frames of a DTZS stream that a flip at pos leaves intact and a
    reader decodes before it meets the flip: those wholly before pos, or
    every frame when pos lies in the stream header's element count (bytes
    8-15, checked against the frames only once they are restored)."""
    ends, off = [], 16
    while True:
        length = int.from_bytes(blob[off:off + 8], "little")
        off += 8
        if not length:
            break
        off += length
        ends.append(off)
    return len(ends) if 8 <= pos < 16 else sum(e <= pos for e in ends)


def robustness_phase(dz, fk, blobs: dict, decoded: dict, card: str) -> dict:
    """4g. Byte-flipped copies of phase 4's containers decoded on the card
    (ROBUST_FLIPS): every decode raises a clean exception (not MemoryError
    or SystemExit), and no decode kernel (C, D, D-QT, I) launches on a
    corrupted container: the header and chunk crcs (a v1 container's length
    fields and zlib streams) are checked on the host before any upload. A
    DTZS stream's intact frames before the flip decode as usual, no launch
    beyond theirs (frames_intact_before). Then each good container decodes
    bit-equal to its decode in phase 4: the CUDA context survived. Prints
    one line a container."""
    import collections

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    out: dict = {}
    rng = np.random.default_rng(17)
    for path, n_flips in ROBUST_FLIPS.items():
        blob = blobs[path]
        fk.reset_launches()
        dz.decompress(blob, device="cuda")
        frames = len(dtzs_frames(blob))
        per_frame = {k: fk.LAUNCHES[k] // frames for k in DECODE_KERNELS}
        if path == "ec":
            head = rng.choice(ROBUST_HEAD, n_flips // 4, replace=False)
            positions = np.concatenate([head, rng.choice(
                np.arange(ROBUST_HEAD, len(blob)), n_flips - head.size, replace=False)])
        else:
            allowed = np.arange(len(blob))
            if path == "v1_ec":
                allowed = np.setdiff1d(allowed, np.fromiter(V1_UNCHECKED, int))
            positions = rng.choice(allowed, n_flips, replace=False)
        kinds: collections.Counter = collections.Counter()
        beyond = []
        t0 = time.perf_counter()
        for pos in sorted(int(p) for p in positions):
            b = bytearray(blob)
            b[pos] ^= 0x5A
            fk.reset_launches()
            try:
                dz.decompress(bytes(b), device="cuda")
            except (SystemExit, MemoryError) as e:
                require(False, f"robustness: {path} byte {pos}: {type(e).__name__} {e}")
            except Exception as e:  # noqa: BLE001 - any clean exception is the contract
                kinds[type(e).__name__] += 1
            else:
                require(False, f"robustness: {path} byte {pos}: the flip decoded silently")
            intact = frames_intact_before(blob, pos) if blob[:4] == b"DTZS" else 0
            over = {k: fk.LAUNCHES[k] for k in DECODE_KERNELS
                    if fk.LAUNCHES[k] > intact * per_frame[k]}
            if over:
                beyond.append((pos, over))
        t_flips = time.perf_counter() - t0
        torch.cuda.synchronize()
        y = dz.decompress(blob, device="cuda")
        same = bool(np.array_equal(y, decoded[path]))
        row = {"container": path, "card": card, "bytes": len(blob), "frames": frames,
               "flips": int(len(positions)), "raised": dict(kinds),
               "launches_beyond_intact_frames": beyond, "per_frame_decode_launches":
               {k: v for k, v in per_frame.items() if v}, "good_decode_bit_equal": same,
               "seconds": t_flips}
        emit("robustness", **row)
        out[path] = row
        require(sum(kinds.values()) == len(positions), f"robustness: {path}: {kinds}")
        require(not beyond, f"robustness: {path}: decode kernels launched on corrupted "
                            f"containers {beyond[:4]}")
        require(same, f"robustness: {path}: the good container no longer decodes to its "
                      "phase-4 output")
    out["seconds"] = time.perf_counter() - t_phase
    emit("robustness_phase", card=card, seconds=out["seconds"])
    return out


def bench_phase(fk, ec_dtzs_ratio: float, card: str) -> dict:
    """4h. dctz_tpu_torch.bench.run() at full size, the launch counters
    reset just before and read just after; its compact line printed as it
    is. Requires A, B, C and D launched, the bound satisfied and the ratio
    within RATIO_REL_TOL of ec_dtzs's (the same configuration on the host
    formula's array; the bench makes its array on the card)."""
    from dctz_tpu_torch import bench

    t_phase = time.perf_counter()
    fk.reset_launches()
    rec = bench.run()
    launched = {k: fk.LAUNCHES[k] for k in EC_KERNELS}
    last = rec["last_line"]
    print(json.dumps(last), flush=True)
    rel = last["ratio"] / ec_dtzs_ratio - 1.0
    sec = rec["sections"]
    row = {"card": card, "launches": launched, "ratio": last["ratio"],
           "ec_dtzs_ratio": ec_dtzs_ratio, "ratio_rel_diff": rel,
           "bound_satisfied": last["bound_satisfied"], "gbps": last["value"],
           "vs_baseline": last["vs_baseline"],
           "amortized_ms": {d: sec["amortized"][d]["per_call_s"] * 1e3
                            for d in ("compress", "decompress")},
           "seconds": time.perf_counter() - t_phase}
    emit("bench", **row)
    missing = [k for k, v in launched.items() if v == 0]
    require(not missing, f"bench: kernels not launched: {missing}")
    require(last["bound_satisfied"], "bench: pointwise bound violated")
    require(abs(rel) <= RATIO_REL_TOL, f"bench: ratio {last['ratio']} is {rel:+.2e} "
                                       f"from ec_dtzs's {ec_dtzs_ratio}")
    return dict(row, record=rec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the full JSON report is written")
    # one rank of the sharded phase's multi-rank run (rank_main), which the
    # script starts itself
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--backend", default="gloo", help=argparse.SUPPRESS)
    ap.add_argument("--multi-card", action="store_true",
                    help="on a machine with two or more cards: only the multi-card "
                         "checks (multi_card_phase)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args)
    import numpy as np

    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.core import entropy
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.core import transform
    from dctz_tpu_torch.kernels import build
    from dctz_tpu_torch.ops import compaction as cp
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode
    from dctz_tpu_torch.ops import idpack
    from dctz_tpu_torch.ops import shuffle
    from dctz_tpu_torch.ops.research import _ref, fused_decode, fused_encode_dpk
    from dctz_tpu_torch.bench import card_line
    from dctz_tpu_torch.utils.bench_data import climate_formula_np, climate_formula_np64
    from dctz_tpu_torch.utils.timing import StageTimer

    class RateSnapTimer(StageTimer):
        """A synchronizing StageTimer that copies the launch counters when
        its "rate" stage (the rate="auto" trial encodes) ends, so that a
        path's launches split into the trials' and the frames' own."""

        def __init__(self) -> None:
            super().__init__(sync=True)
            self.after_rate: dict[str, int] = {}

        @contextlib.contextmanager
        def stage(self, name: str):
            with super().stage(name):
                yield
            if name == "rate":
                self.after_rate = dict(fk.LAUNCHES)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    report: dict = {}

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    report["device"] = {"kind": kind, "nvidia_smi": card}

    # 2. build, from the sources in this checkout
    build.build(force=True)
    build.lib()
    ptxas = ptxas_table(build.PTXAS_LOG.read_text())
    emit("build", seconds=round(build.last_build_s, 3), library=str(build.LIB_PATH),
         ptxas=ptxas)
    require(set(SOURCES) <= set(ptxas), f"ptxas reports no kernel of {set(SOURCES) - set(ptxas)}")
    occupancy = build.OCCUPANCY + build.LANE_WALKS + build.REFERENCES
    ctas = {k: build.ctas_per_sm(k) for k in occupancy}
    for k in occupancy:
        emit("occupancy", kernel=k, ctas_per_sm=ctas[k], **ptxas[k])
    for k in PERSISTENT_KERNELS + SECOND_INSTANTIATIONS:
        require(ptxas[k].get("spill_stores") == 0 and ptxas[k].get("spill_loads") == 0,
                f"{k}: ptxas reports spills {ptxas[k]}")
    for k in PERSISTENT_KERNELS:
        require(ctas[k] >= MIN_CTAS_PER_SM, f"{k}: {ctas[k]} resident CTAs per SM")
    report["build"] = {"seconds": build.last_build_s, "ptxas": ptxas, "ctas_per_sm": ctas}

    if args.multi_card:
        report["multi_card"] = multi_card_phase(dz, fk, card)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0

    # 3. kernels against their plain versions, at the main paths' shapes
    def cfg_of(path):
        kw = PATHS[path][0]
        return None if kw is None else dz.CodecConfig(**kw)

    cfg = cfg_of("ec")
    cfg_qt = cfg_of("qt")
    x_np = climate_formula_np(N)
    x_qt_np = x_np.copy()
    x_qt_np[::977] *= np.float32(30.0)
    n = x_np.size
    dev = torch.device("cuda")
    n_pad = n + (-n) % 1024
    nblk_pad = n_pad // 64
    xp = torch.nn.functional.pad(torch.from_numpy(x_np).to(dev), (0, n_pad - n))
    sf, _mean = api._stats_device(xp, n, cfg.sf_adj)
    tol = fused_encode.tolerance(xp, n, cfg.error_bound)
    cw = qz.chunk_width(n_pad, 64)
    cape_k = 128
    kernels = {}

    ids_k, coef_k, ok_k = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True)
    ids_p, coef_p, ok_p = fk._dct_quant_verify_plain(xp, sf, tol, n, cfg, True)
    torch.cuda.synchronize()
    mism = (ids_k != ids_p).float().mean().item()
    err_a = (coef_k - coef_p).abs().max().item()
    emit("kernel_check", kernel="dct_quant_verify", id_mismatch=mism,
         ok_kernel=bool(ok_k), ok_plain=bool(ok_p), coef_max_abs_err=err_a)
    require(mism <= A_ID_MISMATCH_MAX, f"A: id mismatch {mism}")
    require(bool(ok_k) == bool(ok_p), "A: ok flags differ")
    kernels["dct_quant_verify"] = {"max_abs_err": err_a, "id_mismatch": mism}

    outs_k = fk.dpk_pack_compact(ids_k, coef_k, n_pad, cape_k, cw)
    outs_p = fk._dpk_pack_compact_plain(ids_k, coef_k, n_pad, cape_k, cw)
    torch.cuda.synchronize()
    names = ["width", "packed", "exc", "exc_counts", "ac", "ac_counts", "dc"]
    for a, b, nm in zip(outs_k, outs_p, names):
        require(a.shape == b.shape and a.dtype == b.dtype, f"B: {nm} shape/dtype")
        require(torch.equal(a, b), f"B: {nm} differs from the plain version")
    err_b = max_abs_diff(zip(outs_k, outs_p))
    # the escapes B keeps (those among a chunk row's first cape_k
    # exceptions), whose values it reads: for its bound
    _w, _pk, ids_ib, mask_ib = idpack._code_tiles(ids_k, n_pad, 256)
    mask_ib = mask_ib.reshape(-1, cw)
    kept_b = int((mask_ib & (ids_ib.reshape(-1, cw) == 255)
                  & (torch.cumsum(mask_ib.to(torch.int32), 1) <= cape_k)).sum())
    del ids_ib, mask_ib
    emit("kernel_check", kernel="dpk_pack_compact", byte_equal=True,
         max_abs_err=err_b, overflow=bool((outs_k[3] > cape_k).any()), kept_escapes=kept_b)
    kernels["dpk_pack_compact"] = {"max_abs_err": err_b}

    def decode_inputs(blob):
        header, streams, qtable, _cb = ct.parse_v2(blob)
        (width, rows, exc, dc, ac), (n_stream, _tb, cw_d, hcfg) = api._dpk_decode_prep(
            header, streams
        )
        d_in = [torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)
                for a in (width, rows, exc)]
        dc_d = api._combine_planes(torch.from_numpy(np.array(dc)).to(dev))
        ac_d = api._combine_planes(torch.from_numpy(np.array(ac)).to(dev)).contiguous()
        sf_d = torch.tensor(header.scaling_factor, dtype=torch.float32, device=dev)
        q_d = (torch.from_numpy(qtable.astype(np.float32)).to(dev)
               if qtable is not None else None)
        return header, d_in, dc_d, ac_d, sf_d, q_d, n_stream, cw_d, hcfg, exc, ac

    blob0 = dz.compress(x_np, config=cfg, device="cuda")
    header, d_in, dc_d, ac_d, sf_d, _q, n_stream, cw_d, hdr_cfg, exc, ac = decode_inputs(blob0)
    nblk = -(-n_stream // 64)
    ids_ck, acv_ck = fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw_d)
    ids_cp, acv_cp = fk._dpk_unpack_expand_plain(*d_in, ac_d, nblk, n_stream, cw_d)
    torch.cuda.synchronize()
    require(torch.equal(ids_ck, ids_cp), "C: ids differ from the plain version")
    require(torch.equal(acv_ck.view(torch.int32), acv_cp.view(torch.int32)),
            "C: AC grid differs from the plain version")
    err_c = max_abs_diff([(ids_ck, ids_cp), (acv_ck, acv_cp)])
    emit("kernel_check", kernel="dpk_unpack_expand", byte_equal=True,
         max_abs_err=err_c, exc_capacity=exc.shape[1], ac_capacity=ac.shape[-1])
    kernels["dpk_unpack_expand"] = {"max_abs_err": err_c}

    x_dk = fk.dequant_idct(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream)
    x_dp = fk._dequant_idct_plain(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream)
    torch.cuda.synchronize()
    err_d = (x_dk - x_dp).abs().max().item()
    lim_d = D_ULPS * EPS32 * header.scaling_factor
    emit("kernel_check", kernel="dequant_idct", max_abs_err=err_d, limit=lim_d)
    require(err_d <= lim_d, f"D: {err_d} > {lim_d}")
    kernels["dequant_idct"] = {"max_abs_err": err_d}

    # QT input: E, A-QT and D-QT
    xq = torch.nn.functional.pad(torch.from_numpy(x_qt_np).to(dev), (0, n_pad - n))
    sf_q, _ = api._stats_device(xq, n, cfg.sf_adj)
    tol_q = fused_encode.tolerance(xq, n, cfg.error_bound)
    qt_e = fused_encode.qtable_qmax(xq, sf_q, cfg.error_bound)
    qt_plain = torch.clamp_min(fused_encode._qtable_qmax_plain(xq, sf_q, cfg_qt), 1.0)
    _ids_ec, coef_ec, _ok = fk.dct_quant_verify(xq, sf_q, tol_q, n, cfg.error_bound, False)
    _w, rmin, rmax = qz._geometry(cfg_qt)
    esc = ~((coef_ec >= rmin) & (coef_ec <= rmax))
    esc[:, 0] = False
    qt_from_a = torch.clamp_min(
        torch.where(esc, coef_ec.abs(), torch.zeros_like(coef_ec)).amax(0), 1.0)
    torch.cuda.synchronize()
    e_ulps = ((qt_e - qt_plain).abs() / torch.maximum(qt_e, qt_plain) / EPS32).max().item()
    err_e = (qt_e - qt_plain).abs().max().item()
    emit("kernel_check", kernel="qtable_qmax", equal_to_a_ec=bool(torch.equal(qt_e, qt_from_a)),
         max_ulps_vs_plain=e_ulps, max_abs_err=err_e,
         entries_above_1=int((qt_e[1:] > 1.0).sum()), qtable_max=qt_e.max().item())
    require(torch.equal(qt_e, qt_from_a), "E: differs from the maximum over A-EC's coefficients")
    require(e_ulps <= E_ULPS, f"E: {e_ulps} ulp from the plain version")
    require(bool((qt_e[1:] > 1.0).any()), "E: the QT input left every entry clamped")
    kernels["qtable_qmax"] = {"max_abs_err": err_e}

    ids_qk, vals_qk, ok_qk = fk.dct_quant_verify(xq, sf_q, tol_q, n, cfg.error_bound,
                                                 True, qt_e)
    ids_qp, vals_qp, ok_qp = fk._dct_quant_verify_plain(xq, sf_q, tol_q, n, cfg_qt,
                                                        True, qt_e)
    torch.cuda.synchronize()
    mism_q = (ids_qk != ids_qp).float().mean().item()
    # the stated budget: coefficients within 32 ulp of the block's max|x/sf|;
    # a stored escape ((c/q)*eb*qtf + side) within that times eb*qtf/q[k],
    # plus 4 ulp of the stored value
    budget = 32 * EPS32 * (xq / sf_q).reshape(-1, 64).abs().amax(1, keepdim=True)
    same = ids_qk == ids_qp
    esc_q = same & (ids_qk == 255) & (torch.arange(64, device=dev) > 0)
    lim = torch.where(esc_q, budget * (cfg.error_bound * cfg_qt.qt_factor) / qt_e
                      + 4 * EPS32 * vals_qp.abs(), budget.expand_as(vals_qp))
    over = ((vals_qk - vals_qp).abs() > lim) & same
    err_aq = (vals_qk - vals_qp).abs()[same].max().item()
    emit("kernel_check", kernel="dct_quant_verify_qt", id_mismatch=mism_q,
         ok_kernel=bool(ok_qk), ok_plain=bool(ok_qp), stored_max_abs_err=err_aq,
         over_budget=int(over.sum()), escapes=int(esc_q.sum()))
    require(mism_q <= A_ID_MISMATCH_MAX, f"A-QT: id mismatch {mism_q}")
    require(bool(ok_qk) == bool(ok_qp), "A-QT: ok flags differ")
    require(not bool(over.any()), "A-QT: stored values outside the budget")
    kernels["dct_quant_verify_qt"] = {"max_abs_err": err_aq, "id_mismatch": mism_q}

    # A's L2 screen on the bench and x30 inputs, EC and QT (each input's own
    # qtable): blocks sent to the exact check and blocks repaired, through
    # A's counters, beside the plain version's counts of the same
    # (the RELAXED instantiations too: their screen's budget is 1024 eps)
    report["screen"] = []
    for inp, x_in, sf_in, tol_in in (("bench", xp, sf, tol), ("x30", xq, sf_q, tol_q)):
        q_in = fused_encode.qtable_qmax(x_in, sf_in, cfg.error_bound)
        q_in_r = fused_encode.qtable_qmax(x_in, sf_in, cfg.error_bound, relaxed=True)
        for name, q, c, rlx in (("dct_quant_verify", None, cfg, False),
                                ("dct_quant_verify_qt", q_in, cfg_qt, False),
                                ("dct_quant_verify_relaxed", None, cfg, True),
                                ("dct_quant_verify_qt_relaxed", q_in_r, cfg_qt, True)):
            ck = torch.zeros(2, dtype=torch.int64, device=dev)
            cp_ = torch.zeros(2, dtype=torch.int64, device=dev)
            fk.dct_quant_verify(x_in, sf_in, tol_in, n, cfg.error_bound, True, q, ck,
                                relaxed=rlx)
            fk._dct_quant_verify_plain(x_in, sf_in, tol_in, n, c, True, q, cp_, rlx)
            (flagged, repaired), (flagged_p, missed_p) = ck.tolist(), cp_.tolist()
            row = {"kernel": name, "input": inp, "blocks": nblk_pad, "flagged": flagged,
                   "repaired": repaired, "flagged_share": flagged / nblk_pad,
                   "repaired_share": repaired / nblk_pad, "plain_flagged": flagged_p,
                   "plain_missed": missed_p}
            emit("screen", **row)
            report["screen"].append(row)
            require(repaired <= flagged, f"{name} on {inp}: repaired blocks the screen passed")

    blob_q0 = dz.compress(x_qt_np, config=cfg_qt, device="cuda")
    (hq, dq_in, dcq_d, acq_d, sfq_d, q_d, nq_stream, cwq_d, hq_cfg, _e,
     _a) = decode_inputs(blob_q0)
    nblk_q = -(-nq_stream // 64)
    ids_qck, acv_qck = fk.dpk_unpack_expand(*dq_in, acq_d, nblk_q, nq_stream, cwq_d)
    ids_qcp, acv_qcp = fk._dpk_unpack_expand_plain(*dq_in, acq_d, nblk_q, nq_stream, cwq_d)
    torch.cuda.synchronize()
    require(torch.equal(ids_qck, ids_qcp), "C: ids of the x30 QT rows differ from the plain version")
    require(torch.equal(acv_qck.view(torch.int32), acv_qcp.view(torch.int32)),
            "C: AC grid of the x30 QT rows differs from the plain version")
    emit("kernel_check", kernel="dpk_unpack_expand", input="x30 qt", byte_equal=True,
         exc_capacity=dq_in[2].shape[1], ac_capacity=acq_d.shape[-1], cw=cwq_d)
    del ids_qcp, acv_qcp
    x_dqk = fk.dequant_idct(ids_qck, acv_qck, dcq_d, sfq_d, hq_cfg, nq_stream, q_d)
    x_dqp = fk._dequant_idct_plain(ids_qck, acv_qck, dcq_d, sfq_d, hq_cfg, nq_stream, q_d)
    co_q = qz.decode_dense(ids_qck, dcq_d, acv_qck, nblk_q * 64, hq_cfg, q_d)
    lim_dq = (D_ULPS * EPS32 * hq.scaling_factor * co_q.abs().amax(1)).repeat_interleave(64)
    torch.cuda.synchronize()
    err_dq = (x_dqk - x_dqp).abs().max().item()
    over_dq = int(((x_dqk - x_dqp).abs() > lim_dq).sum())
    emit("kernel_check", kernel="dequant_idct_qt", max_abs_err=err_dq,
         over_budget=over_dq, limit_min=lim_dq.min().item())
    require(over_dq == 0, f"D-QT: {over_dq} samples beyond 32 ulp of sf*max|coef|")
    kernels["dequant_idct_qt"] = {"max_abs_err": err_dq}

    # the non-DPK kernels at the v1 paths' shapes (the bench array; 32Mi is
    # its own 1024 pad). F and G: no id mismatch against the plain version,
    # DC and stored values within the budget above; F: the same ids as A
    # (verify off) at every AC position and the same values at DC and the
    # escapes
    budget_b = 32 * EPS32 * (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)
    col = torch.arange(64, device=dev)
    ids_f, dcac_f = fused_encode.dct_quant(xp, sf, cfg.error_bound)
    ids_fp, dcac_fp = fused_encode._dct_quant_plain(xp, sf, cfg)
    ids_a0, coef_a0, _ok = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, False)
    torch.cuda.synchronize()
    esc_f = (ids_f == 255) & (col > 0)
    mism_f = int((ids_f != ids_fp).sum())
    err_f = (dcac_f - dcac_fp).abs().max().item()
    like_a = (torch.equal(ids_f[:, 1:], ids_a0[:, 1:])
              and torch.equal(dcac_f[esc_f], coef_a0[esc_f])
              and torch.equal(dcac_f[:, 0], coef_a0[:, 0]))
    emit("kernel_check", kernel="dct_quant", id_mismatches=mism_f, max_abs_err=err_f,
         escapes=int(esc_f.sum()), equal_to_a=like_a)
    require(mism_f == 0, f"F: {mism_f} id mismatches")
    require(bool(((dcac_f - dcac_fp).abs() <= budget_b).all()), "F: dcac beyond the budget")
    require(like_a, "F: differs from kernel A's ids or coefficients")
    kernels["dct_quant"] = {"max_abs_err": err_f, "id_mismatch": 0.0}

    q_b = fused_encode.qtable_qmax(xp, sf, cfg.error_bound)
    ids_g, dcac_g = fused_encode.dct_quant(xp, sf, cfg.error_bound, q_b)
    ids_gp, dcac_gp = fused_encode._dct_quant_plain(xp, sf, cfg_qt, q_b)
    torch.cuda.synchronize()
    esc_g = (ids_g == 255) & (col > 0)
    mism_g = int((ids_g != ids_gp).sum())
    lim_g = torch.where(esc_g, budget_b * (cfg.error_bound * cfg_qt.qt_factor) / q_b
                        + 4 * EPS32 * dcac_gp.abs(), budget_b.expand_as(dcac_gp))
    over_g = int(((dcac_g - dcac_gp).abs() > lim_g).sum())
    err_g = (dcac_g - dcac_gp).abs().max().item()
    emit("kernel_check", kernel="dct_quant_qt", id_mismatches=mism_g, max_abs_err=err_g,
         over_budget=over_g, escapes=int(esc_g.sum()),
         qtable_entries_above_1=int((q_b[1:] > 1.0).sum()))
    require(mism_g == 0, f"G: {mism_g} id mismatches")
    require(over_g == 0, "G: stored values beyond the budget")
    kernels["dct_quant_qt"] = {"max_abs_err": err_g, "id_mismatch": 0.0}

    # the RELAXED instantiations (dct_precision="high") on the bench array,
    # as the relaxed paths call them, each against its plain version
    # (transform.dot_bf16x3 on the card): the largest coefficient difference
    # in eps32 * max|x/sf| of its block beside RELAXED_BUDGET (stored QT
    # escapes: that budget times eb*qt_factor/q[k], plus 4 ulp) and the ids
    # that differ (at most A_ID_MISMATCH_MAX of them: a coefficient within
    # the budget of a bin edge); A-relaxed (verify off) equal to F-relaxed
    # and A-QT-relaxed to G-relaxed, E-relaxed to the clamped maximum over
    # A-relaxed's coefficients, bit for bit (one routine,
    # dct_tile.cuh:tile_product_bf16x3); and the HIGHEST arm's coefficients
    # beyond the budget somewhere (the relaxed launch took the relaxed arm)
    mx_b = (xp / sf).reshape(-1, 64).abs().amax(1, keepdim=True)

    def eps_of_max(a, b, mask):
        """max |a - b| over mask, in eps32 * max|x/sf| of the block."""
        r = (a - b).abs() / (EPS32 * mx_b)
        return r[mask].max().item() if bool(mask.any()) else 0.0

    every = torch.ones_like(coef_a0, dtype=torch.bool)
    ids_ar, coef_ar, ok_ar = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True,
                                                 relaxed=True)
    ids_arp, coef_arp, ok_arp = fk._dct_quant_verify_plain(xp, sf, tol, n, cfg, True,
                                                           relaxed=True)
    ids_a0r, coef_a0r, _ok = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, False,
                                                 relaxed=True)
    torch.cuda.synchronize()
    rel_a = eps_of_max(coef_ar, coef_arp, every)
    diff_a = int((ids_ar != ids_arp).sum())
    vs_highest = eps_of_max(coef_a0r, coef_a0, every)
    emit("kernel_check", kernel="dct_quant_verify_relaxed", coef_max_err=rel_a,
         unit="eps32 * max|x/sf| of the block", tolerance=RELAXED_BUDGET, ids_differ=diff_a,
         ids=ids_ar.numel(), id_tolerance=A_ID_MISMATCH_MAX, ok_kernel=bool(ok_ar),
         ok_plain=bool(ok_arp), highest_arm_max_diff=vs_highest)
    require(rel_a <= RELAXED_BUDGET, f"A-relaxed: {rel_a} eps*max|xs| from its plain version")
    require(diff_a <= A_ID_MISMATCH_MAX * ids_ar.numel(), f"A-relaxed: {diff_a} ids differ")
    require(bool(ok_ar) == bool(ok_arp), "A-relaxed: ok flags differ")
    require(vs_highest > RELAXED_BUDGET, "A-relaxed: within the budget of the HIGHEST arm")
    kernels["dct_quant_verify_relaxed"] = {
        "max_abs_err": (coef_ar - coef_arp).abs().max().item(), "id_mismatch": diff_a}

    ids_fr, dcac_fr = fused_encode.dct_quant(xp, sf, cfg.error_bound, relaxed=True)
    ids_frp, dcac_frp = fused_encode._dct_quant_plain(xp, sf, cfg, relaxed=True)
    torch.cuda.synchronize()
    esc_fr = (ids_fr == 255) & (col > 0)
    keep_fr = (ids_fr == ids_frp) & (esc_fr | (col == 0))
    rel_f = eps_of_max(dcac_fr, dcac_frp, keep_fr)
    diff_f = int((ids_fr != ids_frp).sum())
    like_ar = (torch.equal(ids_fr[:, 1:], ids_a0r[:, 1:])
               and torch.equal(dcac_fr[esc_fr].view(torch.int32), coef_a0r[esc_fr].view(torch.int32))
               and torch.equal(dcac_fr[:, 0].view(torch.int32), coef_a0r[:, 0].view(torch.int32)))
    emit("kernel_check", kernel="dct_quant_relaxed", coef_max_err=rel_f,
         unit="eps32 * max|x/sf| of the block", tolerance=RELAXED_BUDGET, ids_differ=diff_f,
         ids=ids_fr.numel(), equal_to_a_relaxed=like_ar)
    require(rel_f <= RELAXED_BUDGET, f"F-relaxed: {rel_f} eps*max|xs| from its plain version")
    require(diff_f <= A_ID_MISMATCH_MAX * ids_fr.numel(), f"F-relaxed: {diff_f} ids differ")
    require(like_ar, "F-relaxed: differs from A-relaxed's ids or coefficients")
    kernels["dct_quant_relaxed"] = {
        "max_abs_err": (dcac_fr - dcac_frp).abs()[keep_fr].max().item(), "id_mismatch": diff_f}

    q_r = fused_encode.qtable_qmax(xp, sf, cfg.error_bound, relaxed=True)
    q_rp = torch.clamp_min(fused_encode._qtable_qmax_plain(xp, sf, cfg_qt, True), 1.0)
    esc_a0r = ~((coef_a0r >= rmin) & (coef_a0r <= rmax)) & (col > 0)
    q_from_a = torch.clamp_min(
        torch.where(esc_a0r, coef_a0r.abs(), torch.zeros_like(coef_a0r)).amax(0), 1.0)
    torch.cuda.synchronize()
    rel_e = (q_r - q_rp).abs().max().item() / (EPS32 * mx_b.max().item())
    # and on the x30 input, whose qtable has entries above 1
    q_rq = fused_encode.qtable_qmax(xq, sf_q, cfg.error_bound, relaxed=True)
    q_rqp = torch.clamp_min(fused_encode._qtable_qmax_plain(xq, sf_q, cfg_qt, True), 1.0)
    _ids, coef_q0r, _ok = fk.dct_quant_verify(xq, sf_q, tol_q, n, cfg.error_bound, False,
                                              relaxed=True)
    esc_q0r = ~((coef_q0r >= rmin) & (coef_q0r <= rmax)) & (col > 0)
    q_from_aq = torch.clamp_min(
        torch.where(esc_q0r, coef_q0r.abs(), torch.zeros_like(coef_q0r)).amax(0), 1.0)
    torch.cuda.synchronize()
    rel_eq = (q_rq - q_rqp).abs().max().item() / (EPS32 * (xq / sf_q).abs().max().item())
    emit("kernel_check", kernel="qtable_qmax_relaxed", coef_max_err=rel_e,
         unit="eps32 * max|x/sf| of the array", tolerance=RELAXED_BUDGET,
         equal_to_a_relaxed=bool(torch.equal(q_r, q_from_a)),
         entries_above_1=int((q_r[1:] > 1.0).sum()), x30_coef_max_err=rel_eq,
         x30_equal_to_a_relaxed=bool(torch.equal(q_rq, q_from_aq)),
         x30_entries_above_1=int((q_rq[1:] > 1.0).sum()))
    require(max(rel_e, rel_eq) <= RELAXED_BUDGET,
            f"E-relaxed: {rel_e}, {rel_eq} eps*max|xs| from its plain version")
    require(torch.equal(q_r, q_from_a) and torch.equal(q_rq, q_from_aq),
            "E-relaxed: differs from the maximum over A-relaxed's")
    require(bool((q_rq[1:] > 1.0).any()), "E-relaxed: the x30 input left every entry clamped")
    del coef_q0r, esc_q0r
    kernels["qtable_qmax_relaxed"] = {"max_abs_err": max(
        (q_r - q_rp).abs().max().item(), (q_rq - q_rqp).abs().max().item())}

    def qt_relaxed_check(name, ids_k, vals_k, ids_p, vals_p):
        """A stored value within the budget (QT escapes: scaled) where the
        ids agree; returns (coefficient difference, ids that differ)."""
        same = ids_k == ids_p
        esc = same & (ids_k == 255) & (col > 0)
        coefs = same & ~esc
        lim = budget_r * (cfg.error_bound * cfg_qt.qt_factor) / q_r + 4 * EPS32 * vals_p.abs()
        over = int((((vals_k - vals_p).abs() > lim) & esc).sum())
        rel = eps_of_max(vals_k, vals_p, coefs)
        diff = int((~same).sum())
        require(rel <= RELAXED_BUDGET and over == 0,
                f"{name}: {rel} eps*max|xs|, {over} stored escapes beyond the budget")
        require(diff <= A_ID_MISMATCH_MAX * ids_k.numel(), f"{name}: {diff} ids differ")
        return rel, diff, over, (vals_k - vals_p).abs()[same].max().item()

    budget_r = RELAXED_BUDGET * EPS32 * mx_b
    ids_aqr, vals_aqr, ok_aqr = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True,
                                                    q_r, relaxed=True)
    ids_aqrp, vals_aqrp, ok_aqrp = fk._dct_quant_verify_plain(xp, sf, tol, n, cfg_qt, True,
                                                              q_r, relaxed=True)
    ids_aq0r, vals_aq0r, _ok = fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, False,
                                                   q_r, relaxed=True)
    torch.cuda.synchronize()
    rel_aq, diff_aq, over_aq, abs_aq = qt_relaxed_check(
        "A-QT-relaxed", ids_aqr, vals_aqr, ids_aqrp, vals_aqrp)
    emit("kernel_check", kernel="dct_quant_verify_qt_relaxed", coef_max_err=rel_aq,
         unit="eps32 * max|x/sf| of the block", tolerance=RELAXED_BUDGET, ids_differ=diff_aq,
         ids=ids_aqr.numel(), stored_over_budget=over_aq, ok_kernel=bool(ok_aqr),
         ok_plain=bool(ok_aqrp))
    require(bool(ok_aqr) == bool(ok_aqrp), "A-QT-relaxed: ok flags differ")
    kernels["dct_quant_verify_qt_relaxed"] = {"max_abs_err": abs_aq, "id_mismatch": diff_aq}

    ids_gr, dcac_gr = fused_encode.dct_quant(xp, sf, cfg.error_bound, q_r, relaxed=True)
    ids_grp, dcac_grp = fused_encode._dct_quant_plain(xp, sf, cfg_qt, q_r, relaxed=True)
    torch.cuda.synchronize()
    esc_gr = (ids_gr == 255) & (col > 0)
    rel_g, diff_g, over_gr, abs_g = qt_relaxed_check(
        "G-relaxed", ids_gr, torch.where(esc_gr | (col == 0), dcac_gr, torch.zeros_like(dcac_gr)),
        ids_grp, dcac_grp)
    like_aqr = (torch.equal(ids_gr[:, 1:], ids_aq0r[:, 1:])
                and torch.equal(dcac_gr[esc_gr].view(torch.int32), vals_aq0r[esc_gr].view(torch.int32))
                and torch.equal(dcac_gr[:, 0].view(torch.int32), vals_aq0r[:, 0].view(torch.int32)))
    emit("kernel_check", kernel="dct_quant_qt_relaxed", coef_max_err=rel_g,
         unit="eps32 * max|x/sf| of the block", tolerance=RELAXED_BUDGET, ids_differ=diff_g,
         ids=ids_gr.numel(), stored_over_budget=over_gr, equal_to_a_qt_relaxed=like_aqr,
         qtable_entries_above_1=int((q_r[1:] > 1.0).sum()))
    require(like_aqr, "G-relaxed: differs from A-QT-relaxed's ids or stored values")
    kernels["dct_quant_qt_relaxed"] = {"max_abs_err": abs_g, "id_mismatch": diff_g}

    # H on F's AC escapes at the default capacity, as the v1_ec encode runs it
    mask_h = esc_f.reshape(-1, cw)
    vals_h = dcac_f.reshape(-1, cw)
    capc_h = min(128, cw)

    def took(*expected):
        got = {k: v for k, v in fk.INSTANTIATIONS.items() if v}
        return got == {k: 1 for k in expected}, got

    fk.reset_launches()
    rows_h, cnt_h = shuffle.compact_f32(mask_h, vals_h, capc_h)
    ok_h, walk_h = took("chunk_compact")
    rows_hp, cnt_hp = cp.compact_rows(mask_h, vals_h, capc_h)
    torch.cuda.synchronize()
    require(ok_h, f"H: took {walk_h}, not its word walk")
    require(torch.equal(rows_h.view(torch.int32), rows_hp.view(torch.int32))
            and torch.equal(cnt_h, cnt_hp), "H: differs from the plain version")
    # H's lane walk: the same rows, the mask viewed one byte off 16
    buf_h = torch.empty(mask_h.numel() + 1, dtype=torch.uint8, device=dev)
    buf_h[1:].copy_(mask_h.reshape(-1).view(torch.uint8))
    mask_hl = buf_h[1:].view(mask_h.shape)
    fk.reset_launches()
    rows_hl, cnt_hl = shuffle.compact_f32(mask_hl, vals_h, capc_h)
    ok_hl, walk_hl = took("chunk_compact_lanes")
    torch.cuda.synchronize()
    require(ok_hl, f"H on the offset mask: took {walk_hl}, not its lane walk")
    require(torch.equal(rows_hl.view(torch.int32), rows_hp.view(torch.int32))
            and torch.equal(cnt_hl, cnt_hp), "H's lane walk differs from the plain version")
    del rows_hl, cnt_hl
    # H at v1_cesm's geometry: the generic chain's call (chunk width 128),
    # its arguments taken from one compress of the CESM-sized input
    x_cesm = climate_formula_np(N_CESM)
    calls_h = []
    compact_f32 = shuffle.compact_f32

    def spy(mask, vals, capc):
        calls_h.append((mask.clone(), vals.clone(), capc))
        return compact_f32(mask, vals, capc)

    shuffle.compact_f32 = spy
    try:
        dz.compress(x_cesm, config=cfg_of("v1_cesm"), device="cuda")
    finally:
        shuffle.compact_f32 = compact_f32
    mask_c, vals_c, capc_c = calls_h[0]
    fk.reset_launches()
    rows_c, cnt_c = shuffle.compact_f32(mask_c, vals_c, capc_c)
    ok_c, walk_c = took("chunk_compact")
    rows_cp, cnt_cp = cp.compact_rows(mask_c, vals_c, capc_c)
    torch.cuda.synchronize()
    require(ok_c, f"H at v1_cesm's geometry: took {walk_c}, not its word walk")
    require(torch.equal(rows_c.view(torch.int32), rows_cp.view(torch.int32))
            and torch.equal(cnt_c, cnt_cp), "H at v1_cesm's geometry differs from the plain version")
    emit("kernel_check", kernel="chunk_compact", byte_equal=True, max_abs_err=0.0,
         rows=rows_h.shape[0], cw=cw, capacity=capc_h,
         overflowed_rows=int((cnt_h > capc_h).sum()), instantiation=walk_h,
         lanes_byte_equal=True, lanes_mask_offset=mask_hl.data_ptr() % 16,
         cesm={"rows": rows_c.shape[0], "cw": mask_c.shape[1], "capacity": capc_c,
               "calls": len(calls_h), "overflowed_rows": int((cnt_c > capc_c).sum()),
               "byte_equal": True, "instantiation": walk_c})
    kernels["chunk_compact"] = {"max_abs_err": 0.0}

    # I on what the decode of the v1_ec container hands it
    blob_v1 = dz.compress(x_np, device="cuda")
    h1, bz1, dz1, az1, _q1 = ct.parse_v1(blob_v1)
    raw1 = entropy.inflate_streams([bz1, dz1, az1])
    (ids_h1, _dc1, rows1), n_str1, _cfg1 = api._host_coded_prep(h1, *raw1)
    ids_i = torch.from_numpy(np.array(ids_h1)).to(dev)
    rows_i = torch.from_numpy(np.array(rows1)).to(dev)
    mask_i = (qz.ac_mask(ids_i.shape[0], 64, n_str1, dev) & (ids_i == 255)).reshape(
        rows_i.shape[0], -1)
    acv_i = shuffle.expand(mask_i, rows_i)
    acv_ip = cp.expand_rows(mask_i, rows_i)
    tight_i = torch.from_numpy(np.frombuffer(raw1[2], np.float32, h1.ac_count).copy()).to(dev)
    out_i = torch.zeros_like(acv_i)
    out_i.masked_scatter_(mask_i, tight_i)
    torch.cuda.synchronize()
    require(torch.equal(acv_i.view(torch.int32), acv_ip.view(torch.int32)),
            "I: differs from the plain version")
    require(torch.equal(acv_i, out_i), "I: differs from masked_scatter of the AC stream")
    emit("kernel_check", kernel="chunk_expand", byte_equal=True, max_abs_err=0.0,
         rows=rows_i.shape[0], cw=mask_i.shape[1], capacity=rows_i.shape[1])
    kernels["chunk_expand"] = {"max_abs_err": 0.0}

    # L, M, J and K on the bench array (tile 256, chunk width 512 unless
    # named). L: its integer streams byte-equal to its plain version's (F's
    # ids had no mismatch above), AC and DC within 32 ulp of max|x/sf|; all
    # seven streams equal to F -> pack_ids (cape 128) -> H of F's escapes
    # (the rows H wrote above), DC by value
    lim_l = 32 * EPS32 * (xp / sf).abs().max().item()
    l_out = fused_encode_dpk.fused_encode_dpk(xp, sf, cfg.error_bound)
    l_plain = fused_encode_dpk._fused_encode_dpk_plain(xp, sf, cfg.error_bound)
    chain = idpack.pack_ids(ids_f, n_pad, 256, 128)[:4] + (rows_h, cnt_h, dcac_f[:, 0])
    torch.cuda.synchronize()
    names = ["width", "packed", "exc", "exc_counts", "ac", "ac_counts", "dc"]
    for i, (a, b, c, nm) in enumerate(zip(l_out, l_plain, chain, names)):
        require(a.shape == b.shape == c.shape and a.dtype == b.dtype == c.dtype,
                f"L: {nm} shape/dtype")
        require(torch.equal(a, c) if nm != "dc" else bool((a == c).all()),
                f"L: {nm} differs from F -> pack_ids -> H")
        require(torch.equal(a, b) if nm not in ("ac", "dc")
                else (a - b).abs().max().item() <= lim_l,
                f"L: {nm} differs from the plain version")
    err_l = max_abs_diff(zip(l_out, l_plain))
    # the card-only reference L_ref (csrc/fused_encode_dpk_ref.cu): equal to
    # the same chain, and L equal to it on all seven streams, bit for bit
    l_ref = _ref.fused_encode_dpk_ref(xp, sf, cfg.error_bound)
    torch.cuda.synchronize()
    for a, r, c, nm in zip(l_out, l_ref, chain, names):
        require(torch.equal(r, c) if nm != "dc" else bool((r == c).all()),
                f"L_ref: {nm} differs from F -> pack_ids -> H")
        require(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                            r.view(torch.int32) if r.dtype == torch.float32 else r),
                f"L: {nm} differs from L_ref")
    emit("kernel_check", kernel="fused_encode_dpk", equal_to_f_pack_ids_h=True,
         equal_to_ref=True,
         checks={"L_ref = F -> pack_ids -> H": "the tiled forward transform "
                 "(csrc/dct_tile.cuh: A, E, F, G, L; here through F) against the "
                 "per-thread one (common.cuh:forward_dct: L_ref)",
                 "L = L_ref": "L on dct_tile.cuh and dpk_stages.cuh against the "
                 "per-thread transform and the per-byte stages of dpk_tile.cuh"},
         integer_streams_equal_to_plain=True, max_abs_err=err_l, limit=lim_l,
         exc_peak=int(l_out[3].max()), ac_peak=int(l_out[5].max()))
    kernels["fused_encode_dpk"] = {"max_abs_err": err_l}

    # B on A (verify off, which equals F bit for bit above) against L_ref,
    # which keeps the per-byte stages of dpk_tile.cuh (L shares B's):
    # width, packed, exception rows and counts, DC by value; the AC streams
    # where no chunk row holds more than 128 exceptions (beyond that the two
    # kernels' AC rules differ)
    outs_bl = fk.dpk_pack_compact(ids_a0, coef_a0, n_pad, 128, cw)
    torch.cuda.synchronize()
    for i, nm in enumerate(names[:4]):
        require(torch.equal(outs_bl[i], l_ref[i]), f"B: {nm} differs from L_ref's")
    require(bool((outs_bl[6] == l_ref[6]).all()), "B: dc differs from L_ref's")
    ac_vs_l = int(outs_bl[3].max()) <= 128
    if ac_vs_l:
        require(torch.equal(outs_bl[4], l_ref[4]) and torch.equal(outs_bl[5], l_ref[5]),
                "B: AC streams differ from L_ref's")
    emit("kernel_check", kernel="dpk_pack_compact", equal_to_l_ref=True,
         checks="B's word-wide stages (csrc/dpk_stages.cuh) against the per-byte "
                "ones of dpk_tile.cuh (L_ref)",
         ac_streams_compared=ac_vs_l, exc_peak=int(outs_bl[3].max()))
    del outs_bl, l_ref

    # M on L's streams: C + D's bits, and the round trip within the bound
    w_l, pk_l, exc_l, _ec, ac_l, _acn, dc_l = l_out
    require(int(l_out[3].max()) <= 128 and int(l_out[5].max()) <= 128,
            "L: a chunk row holds more than 128 exceptions or escapes")
    x_m = fused_decode.fused_decode_dpk(w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad, 256,
                                        512, cfg)
    x_cd = fk.decode_fused(w_l, pk_l, exc_l, ac_l, dc_l, sf, cfg, 512, n_pad)
    torch.cuda.synchronize()
    tol_bench = cfg.error_bound * float(x_np.max() - x_np.min())
    rt_err = (x_m - xp).abs().max().item()
    require(torch.equal(x_m.view(torch.int32), x_cd.view(torch.int32)),
            "M: differs from C + D at tile 256")
    require(rt_err <= tol_bench, f"L -> M round trip: {rt_err} > {tol_bench}")
    # the card-only reference M_ref (csrc/fused_decode_dpk_ref.cu): C + D's
    # bits (the check of the tiled inverse transform against the per-thread
    # one), and M bit-equal to it
    bits = lambda v: v.view(torch.int32)  # noqa: E731
    x_mr = _ref.fused_decode_dpk_ref(w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad, 256, 512, cfg)
    torch.cuda.synchronize()
    require(torch.equal(bits(x_mr), bits(x_cd)), "M_ref: differs from C + D at tile 256")
    require(torch.equal(bits(x_m), bits(x_mr)), "M: differs from M_ref at tile 256")
    walks = {"256 ec": fused_decode.walk_of(256, 512)}
    del x_mr

    def m_budget(arrays, sf_m, b, cw_m, cfg_m, q_m):
        co = fused_decode._coefficients_plain(*arrays, b, cw_m, cfg_m, q_m)
        return (D_ULPS * EPS32 * float(sf_m) * co.abs().amax(1)).repeat_interleave(64)[:n_pad]

    # M at another tile, on the streams pack_ids_with_ac (kernel J) codes
    # from F's output; tile 64 unless a chunk row there overflows 128
    for b_m in (64, 128, 32):
        st_j = idpack.pack_ids_with_ac(ids_f, dcac_f, n_pad, b_m, 128)
        if int(st_j[3].max()) <= 128 and int(st_j[5].max()) <= 128:
            break
    else:
        raise AssertionError("M: every tile of 64, 128, 32 overflows 128")
    arr_j = (st_j[0], st_j[1], st_j[2], st_j[6], st_j[4])
    x_mb = fused_decode.fused_decode_dpk(*arr_j, sf, n_pad, b_m, cw, cfg)
    x_mbp = fused_decode._fused_decode_dpk_plain(*arr_j, sf, n_pad, b_m, cw, cfg, None)
    lim_mb = m_budget(arr_j, sf, b_m, cw, cfg, None)
    torch.cuda.synchronize()
    over_mb = int(((x_mb - x_mbp).abs() > lim_mb).sum())
    err_m = max((x_m - fused_decode._fused_decode_dpk_plain(
        w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad, 256, 512, cfg, None)).abs().max().item(),
        (x_mb - x_mbp).abs().max().item())
    require(over_mb == 0, f"M at tile {b_m}: {over_mb} samples beyond D's budget")
    require((x_mb - xp).abs().max().item() <= tol_bench, f"M at tile {b_m}: bound")
    x_mbr = _ref.fused_decode_dpk_ref(*arr_j, sf, n_pad, b_m, cw, cfg)
    torch.cuda.synchronize()
    require(torch.equal(bits(x_mb), bits(x_mbr)), f"M: differs from M_ref at tile {b_m}")
    walks[f"{b_m} ec"] = fused_decode.walk_of(b_m, cw)
    del x_mbr

    # M in QT on the x30 input: G's ids and stored values with E's qtable
    # (entries above 1), coded by kernel B at tile 256 and full capacity, at
    # the first chunk width of 512, 256, 128 whose rows hold at most 128
    # exceptions (the format takes any of them; the x30 spikes put 136 in a
    # row of 512), cut to the capacity tier of the peaks; C + D-QT decode
    # the same streams
    ids_g2, dcac_g2 = fused_encode.dct_quant(xq, sf_q, cfg.error_bound, qt_e)
    qt_peaks = {}
    for cw_q in (512, 256, 128):
        st_q = fk.encode_fused(ids_g2, dcac_g2, n_pad, 256, cw_q, cw_q)
        pe, pc = int(st_q[3].max()), int(st_q[5].max())
        qt_peaks[cw_q] = [pe, pc]
        if pe <= 128 and pc <= 128:
            break
    else:
        raise AssertionError(f"M-QT: every chunk width overflows 128: {qt_peaks}")
    tier = lambda p: next(c for c in (32, 64, 128) if c >= p)  # noqa: E731
    arr_q = (st_q[0], st_q[1], st_q[2][:, :tier(pe)].contiguous(), st_q[6],
             st_q[4][:, :tier(pc)].contiguous())
    x_mq = fused_decode.fused_decode_dpk(*arr_q, sf_q, n_pad, 256, cw_q, cfg_qt, qt_e)
    x_mqp = fused_decode._fused_decode_dpk_plain(*arr_q, sf_q, n_pad, 256, cw_q, cfg_qt,
                                                 qt_e)
    x_cdq = fk.decode_fused(st_q[0], st_q[1], st_q[2], st_q[4], st_q[6], sf_q, cfg_qt,
                            cw_q, n_pad, qt_e)
    lim_mq = m_budget(arr_q, sf_q, 256, cw_q, cfg_qt, qt_e)
    torch.cuda.synchronize()
    over_mq = int(((x_mq - x_mqp).abs() > lim_mq).sum())
    over_cdq = int(((x_mq - x_cdq).abs() > lim_mq).sum())
    err_m = max(err_m, (x_mq - x_mqp).abs().max().item())
    x_mqr = _ref.fused_decode_dpk_ref(*arr_q, sf_q, n_pad, 256, cw_q, cfg_qt, qt_e)
    torch.cuda.synchronize()
    require(torch.equal(bits(x_mqr), bits(x_cdq)), "M_ref-QT: differs from C + D-QT")
    require(torch.equal(bits(x_mq), bits(x_mqr)), "M-QT: differs from M_ref")
    walks["256 qt"] = fused_decode.walk_of(256, cw_q)
    # M-QT at the other tile: the same G streams coded at tile b_m (J) and
    # chunk width cw (rows past 128 exceptions read their overflow as 0, in
    # both kernels alike)
    st_q64 = idpack.pack_ids_with_ac(ids_g2, dcac_g2, n_pad, b_m, 128)
    arr_q64 = (st_q64[0], st_q64[1], st_q64[2], st_q64[6], st_q64[4])
    x_mq64 = fused_decode.fused_decode_dpk(*arr_q64, sf_q, n_pad, b_m, cw, cfg_qt, qt_e)
    x_mq64r = _ref.fused_decode_dpk_ref(*arr_q64, sf_q, n_pad, b_m, cw, cfg_qt, qt_e)
    torch.cuda.synchronize()
    require(torch.equal(bits(x_mq64), bits(x_mq64r)), f"M-QT: differs from M_ref at tile {b_m}")
    walks[f"{b_m} qt"] = fused_decode.walk_of(b_m, cw)
    geom = {"256 ec": (256, 512), f"{b_m} ec": (b_m, cw), "256 qt": (256, cw_q),
            f"{b_m} qt": (b_m, cw)}
    lib_walks = {k: "words" if build.lib().dctz_fused_decode_dpk_word_walk(*geom[k])
                 else "lanes" for k in walks}
    require(lib_walks == walks, f"M: the library's instantiations {lib_walks} differ "
                                f"from walk_of's {walks}")
    del x_mqr, x_mq64, x_mq64r, st_q64, arr_q64
    emit("kernel_check", kernel="fused_decode_dpk", bit_equal_to_c_d=True,
         round_trip_max_err=rt_err, bound=tol_bench, tile=b_m,
         tile_exc_peak=int(st_j[3].max()), qt_input="x30", qt_chunk_width=cw_q,
         qt_peaks=qt_peaks, qt_capacities=[arr_q[2].shape[1], arr_q[4].shape[1]],
         qt_entries_above_1=int((qt_e[1:] > 1.0).sum()),
         qt_bit_equal_to_c_d=bool(torch.equal(x_mq.view(torch.int32), x_cdq.view(torch.int32))),
         over_budget=over_mq, over_budget_vs_c_d=over_cdq, max_abs_err=err_m,
         equal_to_ref=True, ref_equal_to_c_d=True, instantiations=walks,
         checks={"M_ref = C + D, C + D-QT": "the tiled inverse transform "
                 "(csrc/dct_tile.cuh: D, D-QT, M) against the per-thread one "
                 "(common.cuh:inverse_dct: M_ref)",
                 "M = M_ref": "M's word walk and tiled transform against the per-byte "
                 "unpacking, ballot walk and per-thread transform"})
    require(over_mq == 0 and over_cdq == 0, "M-QT: beyond D's budget")
    require(torch.equal(x_mq.view(torch.int32), x_cdq.view(torch.int32)),
            "M-QT: differs from C + D-QT")
    kernels["fused_decode_dpk"] = {"max_abs_err": err_m}

    # J: pack_ids_with_ac at tile 64 launches J (kernel B takes tile 256) and
    # gives its plain version's bytes
    st_j64 = st_j if b_m == 64 else idpack.pack_ids_with_ac(ids_f, dcac_f, n_pad, 64, 128)
    st_j64p = idpack._pack_ids_with_ac_plain(ids_f, dcac_f, n_pad, 64, 128)
    _w, _pk, ids_i64, mask64 = idpack._code_tiles(ids_f, n_pad, 64)
    mask_j, idb_j = mask64.reshape(-1, cw), ids_i64.to(torch.uint8).reshape(-1, cw)
    vals_j = dcac_f.reshape(-1, cw)
    torch.cuda.synchronize()
    for a, b in zip(st_j64, st_j64p):
        require(a.dtype == b.dtype and torch.equal(a, b), "J: differs from the plain version")
    # J alone on the same rows: its word walk, and its lane walk on the id
    # bytes viewed 8 bytes off 16
    j_plain = shuffle._compact_unified_plain(mask_j, idb_j, vals_j, 128, 128, 128)
    fk.reset_launches()
    j_words = shuffle.compact_unified(mask_j, idb_j, vals_j, 128, 128)
    ok_j, walk_j = took("chunk_compact_unified")
    buf_j = torch.empty(idb_j.numel() + 8, dtype=torch.uint8, device=dev)
    buf_j[8:].copy_(idb_j.reshape(-1))
    idb_jl = buf_j[8:].view(idb_j.shape)
    fk.reset_launches()
    j_lanes = shuffle.compact_unified(mask_j, idb_jl, vals_j, 128, 128)
    ok_jl, walk_jl = took("chunk_compact_unified_lanes")
    torch.cuda.synchronize()
    require(ok_j, f"J: took {walk_j}, not its word walk")
    require(ok_jl, f"J on the offset id bytes: took {walk_jl}, not its lane walk")
    for got, what in ((j_words, "word"), (j_lanes, "lane")):
        require(torch.equal(got[0], j_plain[0])
                and torch.equal(got[1].view(torch.int32), j_plain[1].view(torch.int32)),
                f"J's {what} walk differs from the plain version")
    require(torch.equal(j_words[0], st_j64[2]) and torch.equal(j_words[1], st_j64[4]),
            "J alone differs from pack_ids_with_ac's rows")
    del j_lanes, j_plain
    emit("kernel_check", kernel="chunk_compact_unified", byte_equal=True, max_abs_err=0.0,
         tile=64, rows=mask_j.shape[0], cw=cw, exc_peak=int(st_j64[3].max()),
         instantiation=walk_j, lanes_byte_equal=True,
         lanes_id_offset=idb_jl.data_ptr() % 16)
    kernels["chunk_compact_unified"] = {"max_abs_err": 0.0}

    # K on the DPK exception mask and id bytes of F's ids (tile 256): the
    # plain version's rows, and the exception rows of pack_ids and of L, in
    # its word walk; and its lane walk on the id bytes viewed 8 bytes off 16
    _w, _pk, ids_i256, mask256 = idpack._code_tiles(ids_f, n_pad, 256)
    mask_k, byt_k = mask256.reshape(-1, cw), ids_i256.to(torch.uint8).reshape(-1, cw)
    fk.reset_launches()
    rows_k = shuffle.compact_bytes(mask_k, byt_k, 128)
    ok_k, walk_k = took("chunk_compact_bytes")
    rows_kp = cp.compact_rows(mask_k, byt_k, 128)[0]
    buf_k = torch.empty(byt_k.numel() + 8, dtype=torch.uint8, device=dev)
    buf_k[8:].copy_(byt_k.reshape(-1))
    byt_kl = buf_k[8:].view(byt_k.shape)
    fk.reset_launches()
    rows_kl = shuffle.compact_bytes(mask_k, byt_kl, 128)
    ok_kl, walk_kl = took("chunk_compact_bytes_lanes")
    torch.cuda.synchronize()
    require(ok_k, f"K: took {walk_k}, not its word walk")
    require(ok_kl, f"K on the offset bytes: took {walk_kl}, not its lane walk")
    require(torch.equal(rows_k, rows_kp), "K: differs from the plain version")
    require(torch.equal(rows_kl, rows_kp), "K's lane walk differs from the plain version")
    require(torch.equal(rows_k, chain[2]) and torch.equal(rows_k, exc_l),
            "K: differs from the exception rows of pack_ids and L")
    del rows_kl
    emit("kernel_check", kernel="chunk_compact_bytes", byte_equal=True, max_abs_err=0.0,
         rows=mask_k.shape[0], cw=cw, capacity=128, instantiation=walk_k,
         equal_to_l=True, lanes_byte_equal=True, lanes_byte_offset=byt_kl.data_ptr() % 16)
    kernels["chunk_compact_bytes"] = {"max_abs_err": 0.0}

    # the item-9 operands: A (verify on), A-QT, E, D and D-QT at bin
    # geometries scaled by brsf (runtime operands w, rmin, rmax, computed in
    # doubles and rounded once), each against its plain version by the
    # rules above (D on A's own stored values: the escapes and the DC); J
    # on the XLA chain's DPK route at block size 128 (rows of 512) and at
    # 48 on the input cut to a multiple of 480 samples (rows of 480, which
    # J takes: a multiple of 32), byte-equal to its plain version
    report["item9_kernels"] = []
    col = torch.arange(64, device=dev)
    for brsf in CHECK_BRSFS:
        for mode in ("ec", "qt"):
            cfg_b = dz.CodecConfig(mode=mode, error_bound=cfg.error_bound, brsf=brsf)
            x_b, sf_b, tol_b = (xp, sf, tol) if mode == "ec" else (xq, sf_q, tol_q)
            q_b9 = e_ulps_b = None
            if mode == "qt":
                q_b9 = fused_encode.qtable_qmax(x_b, sf_b, cfg.error_bound, brsf=brsf)
                q_b9p = torch.clamp_min(fused_encode._qtable_qmax_plain(x_b, sf_b, cfg_b),
                                        1.0)
                e_ulps_b = ((q_b9 - q_b9p).abs() / torch.maximum(q_b9, q_b9p)
                            / EPS32).max().item()
                require(e_ulps_b <= E_ULPS, f"E at brsf {brsf}: {e_ulps_b} ulp")
            ik, vk, okk = fk.dct_quant_verify(x_b, sf_b, tol_b, n, cfg.error_bound, True,
                                              q_b9, brsf=brsf)
            ip, vp, okp = fk._dct_quant_verify_plain(x_b, sf_b, tol_b, n, cfg_b, True, q_b9)
            mism_b = (ik != ip).float().mean().item()
            bud = 32 * EPS32 * (x_b / sf_b).reshape(-1, 64).abs().amax(1, keepdim=True)
            same_b = ik == ip
            esc_b = same_b & (ik == 255) & (col > 0)
            lim_b = bud.expand_as(vp)
            if q_b9 is not None:
                lim_b = torch.where(esc_b, bud * (cfg.error_bound * cfg_b.qt_factor) / q_b9
                                    + 4 * EPS32 * vp.abs(), lim_b)
            over_b = int((((vk - vp).abs() > lim_b) & same_b).sum())
            ids_d = torch.where(col > 0, ik, torch.full_like(ik, 255))
            acv_b = torch.where((ids_d == 255) & (col > 0), vk, torch.zeros_like(vk))
            dc_b = vk[:, 0].contiguous()
            xd_k = fk.dequant_idct(ids_d, acv_b, dc_b, sf_b, cfg_b, n_pad, q_b9)
            xd_p = fk._dequant_idct_plain(ids_d, acv_b, dc_b, sf_b, cfg_b, n_pad, q_b9)
            co_b = qz.decode_dense(ids_d, dc_b, acv_b, n_pad, cfg_b, q_b9)
            lim_db = (D_ULPS * EPS32 * sf_b * co_b.abs().amax(1)).repeat_interleave(64)
            over_db = int(((xd_k - xd_p).abs() > lim_db).sum())
            torch.cuda.synchronize()
            row = {"brsf": brsf, "mode": mode, "a_id_mismatch": mism_b,
                   "a_ok_kernel": bool(okk), "a_ok_plain": bool(okp),
                   "a_over_budget": over_b, "escapes": int(esc_b.sum()),
                   "a_max_abs_err": (vk - vp).abs()[same_b].max().item(),
                   "e_max_ulps": e_ulps_b, "d_over_budget": over_db,
                   "d_max_abs_err": (xd_k - xd_p).abs().max().item(),
                   "w_rmax": list(qz._geometry(cfg_b))[::2]}
            emit("item9_kernel_check", **row)
            report["item9_kernels"].append(row)
            require(mism_b <= A_ID_MISMATCH_MAX, f"A at brsf {brsf} {mode}: id mismatch")
            require(bool(okk) == bool(okp), f"A at brsf {brsf} {mode}: ok flags differ")
            require(over_b == 0, f"A at brsf {brsf} {mode}: values beyond the budget")
            require(over_db == 0, f"D at brsf {brsf} {mode}: beyond 32 ulp")
    for bs_j in (128, 48):
        cfg_j = dz.CodecConfig(error_bound=cfg.error_bound, block_size=bs_j, verify=True)
        cw_want = 512 // bs_j * bs_j  # rows of 512 and 480 samples
        n_j = n - n % cw_want
        x_j = torch.from_numpy(x_np[:n_j]).to(dev)
        sf_j9, _m, tol_j9 = api._chain_stats(x_j, n_j, cfg_j)
        from dctz_tpu_torch import stream as dstream

        ids_j9, dc_j9, vals_j9, _q, _ok = dstream._quantize_segment(x_j, n_j, sf_j9, tol_j9,
                                                                   cfg_j)
        dcac_j9 = vals_j9.to(torch.float32)
        dcac_j9[:, 0] = dc_j9
        ids_j9 = ids_j9.to(torch.uint8)
        cw_j9 = qz.chunk_width(ids_j9.numel(), bs_j)
        fk.reset_launches()
        st_k = idpack.pack_ids_with_ac(ids_j9, dcac_j9, n_j, 256, 128)
        torch.cuda.synchronize()
        j_launches = fk.LAUNCHES["chunk_compact_unified"]
        st_p = idpack._pack_ids_with_ac_plain(ids_j9, dcac_j9, n_j, 256, 128)
        equal_j = all(torch.equal(a, b) for a, b in zip(st_k, st_p))
        row = {"block_size": bs_j, "n": n_j, "cw": cw_j9, "j_launches": j_launches,
               "byte_equal": equal_j, "exc_peak": int(st_k[3].max())}
        emit("item9_kernel_check", kernel="chunk_compact_unified", **row)
        report["item9_kernels"].append(row)
        require(equal_j, f"J at block size {bs_j}: differs from the plain version")
        require(cw_j9 == cw_want, f"J at block size {bs_j}: chunk width {cw_j9}")
        require(j_launches == 1, f"J at block size {bs_j} (cw {cw_j9}): {j_launches} launches")
        del x_j, ids_j9, dc_j9, vals_j9, dcac_j9, st_k, st_p

    # 4. end to end through the public API, one path at a time; the counters
    # count each path's own run only
    inputs = {"bench": x_np, "x30": x_qt_np, "cesm": x_cesm,
              "bench64": climate_formula_np64(N), "cesm64": climate_formula_np64(N_CESM)}
    tolx = {k: cfg.error_bound * float(x.max() - x.min()) for k, x in inputs.items()}
    launches, walks_e2e, blobs, decoded, e2e = {}, {}, {}, {}, {}
    for path, (kw, inp, needed) in PATHS.items():
        pcfg = cfg_of(path)
        x = inputs[inp]
        timer = RateSnapTimer()
        fk.reset_launches()
        with timer:
            blob = dz.compress(x, config=pcfg, device="cuda", timer=timer)
        y = dz.decompress(blob, device="cuda")
        launches[path] = dict(fk.LAUNCHES)
        walks_e2e[path] = {k: v for k, v in fk.INSTANTIATIONS.items() if v}
        blobs[path], decoded[path] = blob, y
        ev = dz.evaluate(x, y, cfg.error_bound)
        ratio = x.nbytes / len(blob)
        dtzs = blob[:4] == b"DTZS"
        frames = dtzs_frames(blob)
        fmt0 = ct.detect_format(frames[0])
        heads = [ct.parse_v1(f)[0] if fmt0 == "v1" else ct.parse_v2(f)[0] for f in frames]
        fmt = fmt0 + ("" if fmt0 == "v1" else " dpk" if heads[0].dpk else " host-coded")
        ids_codecs = sorted({ids_codec_of(h, fmt0) for h in heads})
        # H's launches beyond one a frame: the frames whose compaction was
        # retried at full chunk width (a chunk row held more than 128 escapes)
        retried = (launches[path]["chunk_compact"] - len(frames)
                   if "chunk_compact" in needed else None)
        emit("end_to_end", path=path, input=inp, n=x.size, bytes_in=x.nbytes,
             input_dtype=str(x.dtype), output_dtype=str(y.dtype),
             frame_dtypes=sorted({str(h.dtype) for h in heads}),
             bytes_out=len(blob), container=("dtzs " + fmt) if dtzs else fmt,
             frames=len(frames), ids_codec=ids_codecs, dcd=[bool(h.dcd) for h in heads]
             if fmt0 == "v2" else None, compaction_retried=retried,
             ratio=ratio, dtzs=dtzs, launches=launches[path],
             instantiations=walks_e2e[path], psnr_db=ev["psnr_db"],
             max_rel_err=ev["max_rel_err"], bound_satisfied=ev["bound_satisfied"])
        missing = [k for k in needed if launches[path][k] == 0]
        require(not missing, f"{path}: kernels not launched: {missing}")
        ran = [k for k in NEVER.get(path, ()) if launches[path][k]]
        require(not ran, f"{path}: kernels its gates exclude launched: {ran}")
        if dtzs:
            # the frames' own launches: without the rate="auto" trials'
            short = [k for k in needed
                     if launches[path][k] - timer.after_rate.get(k, 0) < len(frames)]
            require(not short, f"{path}: kernels launched fewer times than the "
                               f"{len(frames)} frames: {short}")
        if "chunk_compact" in needed:
            require(set(walks_e2e[path]) == {"chunk_compact"},
                    f"{path}: H took {walks_e2e[path]}, not its word walk alone")
        require(ev["bound_satisfied"], f"{path}: pointwise bound violated")
        seg_p = api._resolve_segment(pcfg or dz.CodecConfig(), x.size)
        if inp in F64_INPUTS:
            # full width: float64 frames (host-coded when segmented) and a
            # float64 decode; internal_dtype="float32": a float64 header on
            # the float32 routes. Kernel D never runs
            require(y.dtype == np.float64, f"{path}: decoded to {y.dtype}")
            require(all(h.dtype == np.float64 for h in heads),
                    f"{path}: a frame that does not declare float64")
            ran_d = [k for k in D_KERNELS if launches[path][k]]
            require(not ran_d, f"{path}: kernel D launched: {ran_d}")
        want = ("dtzs " if seg_p else "") + (
            "v1" if kw is None or "container" not in kw and "segment_elems" not in kw
            else "v2 dpk" if kw.get("ids_codec") == "device"
            and not (seg_p and inp in F64_INPUTS) else "v2 host-coded")
        got = ("dtzs " + fmt) if dtzs else fmt
        require(got == want, f"{path}: wrote {got}, not {want}")
        if (kw or {}).get("dc_delta"):
            require(all(h.dcd for h in heads), f"{path}: a frame without the dcd flag")
        if dtzs and fmt0 == "v2" and not heads[0].dpk:
            # host-coded frames: beside the monolithic path of the same
            # configuration where PATHS has one (no bit-equality: see
            # GENERIC_TWIN)
            mono = GENERIC_TWIN.get(path)
            if mono:
                emit("generic_vs_monolithic", card=card, path=path, ratio=ratio,
                     monolithic=mono, monolithic_ratio=e2e[mono]["ratio"],
                     ratio_rel_diff=ratio / e2e[mono]["ratio"] - 1.0,
                     decode_max_abs_diff=float(np.abs(y - decoded[mono]).max()),
                     bound=tolx[inp])
        elif dtzs:
            # the monolithic path of the same configuration, or (a relaxed
            # path, which has none among PATHS) its container made here
            twin = DTZS_TWIN.get(path)
            y_mono = (decoded[twin] if twin else dz.decompress(dz.compress(
                x, config=dz.CodecConfig(**dict(kw, segment_elems=0)), device="cuda"),
                device="cuda"))
            same_bits = y.tobytes() == y_mono.tobytes()
            emit("dtzs_vs_monolithic", path=path, monolithic=twin or "made here",
                 bit_equal=same_bits)
            require(same_bits, f"{path}: DTZS decode differs from the monolithic decode")

        if path in ITEM9_PATHS:
            e2e[path] = item9_checks(dz, api, path, pcfg, x, blob, y, heads, timer, ratio,
                                     e2e, launches[path], tolx[inp], card)
            continue
        t0 = time.perf_counter()
        blob_cpu = dz.compress(x, config=pcfg, device="cpu")
        t_cpu_c = time.perf_counter() - t0
        ratio_cpu = x.nbytes / len(blob_cpu)
        y_gpu_of_cpu = dz.decompress(blob_cpu, device="cuda")
        t0 = time.perf_counter()
        y_cpu_of_gpu = dz.decompress(blob, device="cpu")
        t_cpu_d = time.perf_counter() - t0
        e1 = float(np.abs(y_gpu_of_cpu - x).max())
        e2 = float(np.abs(y_cpu_of_gpu - x).max())
        emit("cross_check", path=path, ratio_plain=ratio_cpu,
             ratio_rel_diff=ratio / ratio_cpu - 1.0, gpu_decodes_plain_max_err=e1,
             plain_decodes_gpu_max_err=e2, bound=tolx[inp],
             plain_compress_s=t_cpu_c, plain_decompress_s=t_cpu_d)
        require(abs(ratio / ratio_cpu - 1.0) <= RATIO_REL_TOL,
                f"{path}: ratio differs from the plain path")
        require(e1 <= tolx[inp] and e2 <= tolx[inp], f"{path}: cross decode violates the bound")
        e2e[path] = {"ratio": ratio, "ratio_plain": ratio_cpu, "launches": launches[path],
                     "evaluate": ev}
        if path in HIGH_VS_HIGHEST:
            # the relaxed analysis beside the HIGHEST path of the same mode
            hp = HIGH_VS_HIGHEST[path]
            highest = [k for k in needed if k.endswith("_relaxed")]
            require(not any(launches[path][k.removesuffix("_relaxed")] for k in highest),
                    f"{path}: a HIGHEST forward kernel launched")
            emit("relaxed_vs_highest", path=path, ratio=ratio, highest_path=hp,
                 highest_ratio=e2e[hp]["ratio"], ratio_rel_diff=ratio / e2e[hp]["ratio"] - 1.0,
                 max_rel_err=ev["max_rel_err"],
                 highest_max_rel_err=e2e[hp]["evaluate"]["max_rel_err"],
                 bound_satisfied=ev["bound_satisfied"])

    # the one-pass DPK path, through the research entry points and
    # pack_ids_with_ac: L encodes the bench array and M decodes it (tile
    # 256); F, then pack_ids_with_ac at tile 64 (kernel J), then M at that
    # tile; and shuffle.compact_bytes (kernel K, which no caller in either
    # package reaches) on the exception bytes of the tile-256 coding, which
    # must equal L's exception rows
    path = "dpk_onepass"
    x_dev = torch.from_numpy(x_np).to(dev)
    fk.reset_launches()
    sf_o, _ = api._stats_device(x_dev, n, cfg.sf_adj)
    st_o = fused_encode_dpk.fused_encode_dpk(x_dev, sf_o, cfg.error_bound)
    y_o = fused_decode.fused_decode_dpk(st_o[0], st_o[1], st_o[2], st_o[6], st_o[4], sf_o,
                                        n, 256, 512, cfg)
    ids_o, dcac_o = fused_encode.fused_encode_ec(x_dev, sf_o, cfg.error_bound)
    st_64 = idpack.pack_ids_with_ac(ids_o, dcac_o, n, 64, 128)
    y_64 = fused_decode.fused_decode_dpk(st_64[0], st_64[1], st_64[2], st_64[6], st_64[4],
                                         sf_o, n, 64, 512, cfg)
    _w, _pk, ids_oi, mask_o = idpack._code_tiles(ids_o, n, 256)
    exc_o = shuffle.compact_bytes(mask_o.reshape(-1, 512),
                                  ids_oi.to(torch.uint8).reshape(-1, 512), 128)
    torch.cuda.synchronize()
    launches[path] = dict(fk.LAUNCHES)
    walks_e2e[path] = {k: v for k, v in fk.INSTANTIATIONS.items() if v}
    err_o = (y_o - x_dev).abs().max().item()
    err_64 = (y_64 - x_dev).abs().max().item()
    emit("end_to_end", path=path, input="bench", n=n, bytes_in=x_np.nbytes,
         launches=launches[path], instantiations=walks_e2e[path], max_err=err_o,
         max_err_tile64=err_64,
         bound=tolx["bench"], exc_peak=int(st_o[3].max()),
         exc_peak_tile64=int(st_64[3].max()))
    missing = [k for k in ONEPASS_KERNELS + ("dct_quant",) if launches[path][k] == 0]
    require(not missing, f"{path}: kernels not launched: {missing}")
    require(set(walks_e2e[path]) == {"chunk_compact_unified", "chunk_compact_bytes"}
            and walks_e2e[path]["chunk_compact_bytes"] == 1,
            f"{path}: J and K took {walks_e2e[path]}, not their word walks alone")
    require(err_o <= tolx["bench"] and err_64 <= tolx["bench"],
            f"{path}: pointwise bound violated")
    require(int(st_64[3].max()) <= 128, f"{path}: a tile-64 chunk row overflows 128")
    require(torch.equal(exc_o, st_o[2]), f"{path}: K's rows differ from L's")
    e2e[path] = {"launches": launches[path], "max_err": err_o, "max_err_tile64": err_64}
    del x_dev, y_o, y_64, ids_o, dcac_o, mask_o, ids_oi
    report["end_to_end"] = e2e

    # 4b. float64 parity with the C++ codec (cpp/, the reference's double
    # build): the card's v1 containers against native.compress
    from dctz_tpu_torch import native

    require(native.available(), "f64_parity: the native codec did not build")
    report["f64_parity"] = []
    for n_par in (64 * 512, 64 * 512 + 31, 777, N_CESM):
        x_par = (inputs["cesm64"] if n_par == N_CESM
                 else np.random.default_rng(n_par).standard_normal(n_par) * 250)
        for mode in ("ec", "qt"):
            pb = dz.compress(x_par, cfg.error_bound, mode, device="cuda")
            nb = native.compress(x_par, cfg.error_bound, mode)
            same, qt_rel = same_f64_container(pb, nb)
            row = {"n": n_par, "mode": mode, "equal": same, "bytes": len(pb),
                   "qtable_max_rel_diff": qt_rel}
            emit("f64_parity", **row)
            report["f64_parity"].append(row)
            require(same, f"f64_parity: n={n_par} {mode}: the card's container "
                          "differs from the native codec's")

    # 4c. the float64 configurations at a small length, on the card and on
    # the CPU (the segmented ones in 32768-element frames)
    n_cc = 70001
    x_cc = climate_formula_np64(n_cc)
    report["f64_card_vs_cpu"] = []
    for path in F64_PATHS:
        kw_cc = dict(PATHS[path][0])
        if kw_cc.get("segment_elems") == "auto":
            kw_cc["segment_elems"] = 1 << 15
        cfg_cc = dz.CodecConfig(**kw_cc)
        b_gpu = dz.compress(x_cc, config=cfg_cc, device="cuda")
        b_cpu = dz.compress(x_cc, config=cfg_cc, device="cpu")
        same, qt_rel = same_f64_container(b_gpu, b_cpu)
        tol_cc = cfg.error_bound * float(x_cc.max() - x_cc.min())
        e1 = float(np.abs(dz.decompress(b_cpu, device="cuda") - x_cc).max())
        e2 = float(np.abs(dz.decompress(b_gpu, device="cpu") - x_cc).max())
        row = {"path": path, "n": n_cc, "frames": len(dtzs_frames(b_gpu)), "equal": same,
               "qtable_max_rel_diff": qt_rel, "ratio_rel_diff": len(b_cpu) / len(b_gpu) - 1.0,
               "gpu_decodes_plain_max_err": e1, "plain_decodes_gpu_max_err": e2,
               "bound": tol_cc}
        emit("f64_card_vs_cpu", **row)
        report["f64_card_vs_cpu"].append(row)
        require(e1 <= tol_cc and e2 <= tol_cc, f"f64_card_vs_cpu: {path}: cross decode "
                                               "violates the bound")
        if path == "ec_f64_fast":
            require(abs(row["ratio_rel_diff"]) <= RATIO_REL_TOL,
                    f"f64_card_vs_cpu: {path}: ratio differs from the plain path")
        else:
            require(same, f"f64_card_vs_cpu: {path}: the card's container differs "
                          "from the CPU run's")

    # 4d. the drivers and tools (the CLI, the harness, dctz_dump, dct_test)
    report["drivers"] = drivers_phase(dz, fk, native, inputs, blobs["ec"], card)

    # 4e. multi-GPU on the one card: the sharded entry points, two ranks
    report["sharded"] = sharded_phase(dz, fk, inputs, blobs, decoded, card)

    # 4f. the evaluation sweeps that phase 4d leaves off the card
    report["suites"] = suites_phase(dz, fk, native, card)

    # 4g. byte-flipped containers on the card: they raise before the kernels
    report["robustness"] = robustness_phase(dz, fk, blobs, decoded, card)

    # 4h. the port's benchmark entry point, once at full size
    report["bench"] = bench_phase(fk, e2e["ec_dtzs"]["ratio"], card)

    # 5. times (the card's name and power limit go beside every number)
    report["throughput"], report["stages"], report["profile"] = {}, {}, {}
    for path, (kw, inp, _needed) in PATHS.items():
        pcfg, x, blob = cfg_of(path), inputs[inp], blobs[path]
        seg = api._resolve_segment(pcfg or dz.CodecConfig(), x.size)
        reps = REPS_F64 if inp in F64_INPUTS or path in ZLIB_BOUND_PATHS else REPS
        # phase 4 ran every path once already: these runs are warm
        t_c = wall_s(lambda: dz.compress(x, config=pcfg, device="cuda"), reps, warm=False)
        t_d = wall_s(lambda: dz.decompress(blob, device="cuda"), reps, warm=False)
        # GB/s of the input's own bytes: float64 paths count 8 bytes a sample
        gbs_c, gbs_d = x.nbytes / t_c / 1e9, x.nbytes / t_d / 1e9
        emit("throughput", card=card, path=path, compress_gb_s=gbs_c,
             decompress_gb_s=gbs_d, compress_s=t_c, decompress_s=t_d, reps=reps,
             input_dtype=str(x.dtype), ratio=e2e[path]["ratio"])
        tc, td = StageTimer(sync=True), StageTimer(sync=True)
        with tc:
            dz.compress(x, config=pcfg, device="cuda", timer=tc)
        with td:
            dz.decompress(blob, device="cuda", timer=td)
        emit("stages", card=card, path=path, compress=tc.report(x.nbytes),
             decompress=td.report(x.nbytes))
        report["throughput"][path] = {"compress_gb_s": gbs_c, "decompress_gb_s": gbs_d,
                                      "card": card}
        report["stages"][path] = {"compress": tc.report(x.nbytes),
                                  "decompress": td.report(x.nbytes)}
        if path in ("ec", "ec_dtzs", "v1_ec", "v2_deflate_dtzs", "ec_f64", "ec_f64_dtzs"):
            report["profile"][path] = profile_once(dz, x, pcfg, blob, card, path)
        if seg and inp == "bench":
            report.setdefault("pipeline_trace", {})[path] = pipeline_trace(
                dz, x, pcfg, blob, card, path, seg)

    # each kernel's time against its plain version, its bound and, where
    # one PyTorch call computes the same function, that call: bytes are
    # each input read once and each output written once; operations are the
    # fp32 FMAs of the transforms (2 FLOP each): E's, A's, F's and G's
    # forward DCT and D's inverse, 64 per sample (A's verify reconstructs
    # depend on the screen and are not counted, so A's bound is a least
    # time); B and H-K do no arithmetic to speak of, and read a value only
    # where it is kept (B: the DC of each block and the escapes among the
    # first cape_k exceptions of a row; H and K: the first capc masked
    # values of a row; I: one row slot per masked position; J: the id bytes
    # of the first 128 exceptions of a row and the AC values it keeps), so
    # their bytes count those values of this run's data, not the whole
    # value arrays
    dct_flops = 2.0 * 64 * n_pad
    # the relaxed analysis: three bf16 products on the tensor cores
    relaxed_flops = 3 * 2.0 * 64 * n_pad
    out_lib = torch.zeros_like(acv_i)
    library = {
        "chunk_compact": lambda: torch.masked_select(vals_h, mask_h),
        "chunk_expand": lambda: out_lib.masked_scatter_(mask_i, tight_i),
        "chunk_compact_unified": lambda: torch.masked_select(idb_j, mask_j),
        "chunk_compact_bytes": lambda: torch.masked_select(byt_k, mask_k),
    }
    timed = {
        "qtable_qmax": (
            lambda: fused_encode.qtable_qmax(xq, sf_q, cfg.error_bound),
            lambda: fused_encode._qtable_qmax_plain(xq, sf_q, cfg_qt),
            nbytes(xq, qt_e), dct_flops),
        "dct_quant_verify": (
            lambda: fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True),
            lambda: fk._dct_quant_verify_plain(xp, sf, tol, n, cfg, True),
            nbytes(xp, ids_k, coef_k), dct_flops),
        "dct_quant_verify_qt": (
            lambda: fk.dct_quant_verify(xq, sf_q, tol_q, n, cfg.error_bound, True, qt_e),
            lambda: fk._dct_quant_verify_plain(xq, sf_q, tol_q, n, cfg_qt, True, qt_e),
            nbytes(xq, qt_e, ids_qk, vals_qk), dct_flops),
        "dpk_pack_compact": (
            lambda: fk.dpk_pack_compact(ids_k, coef_k, n_pad, cape_k, cw),
            lambda: fk._dpk_pack_compact_plain(ids_k, coef_k, n_pad, cape_k, cw),
            nbytes(ids_k, *outs_k) + 4 * nblk_pad + 4 * kept_b, 0.0),
        "dpk_unpack_expand": (
            lambda: fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw_d),
            lambda: fk._dpk_unpack_expand_plain(*d_in, ac_d, nblk, n_stream, cw_d),
            nbytes(*d_in, ac_d, ids_ck, acv_ck), 0.0),
        "dequant_idct": (
            lambda: fk.dequant_idct(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream),
            lambda: fk._dequant_idct_plain(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream),
            nbytes(ids_ck, acv_ck, dc_d, x_dk), 2.0 * 64 * nblk * 64),
        "dequant_idct_qt": (
            lambda: fk.dequant_idct(ids_qck, acv_qck, dcq_d, sfq_d, hq_cfg, nq_stream, q_d),
            lambda: fk._dequant_idct_plain(ids_qck, acv_qck, dcq_d, sfq_d, hq_cfg,
                                           nq_stream, q_d),
            nbytes(ids_qck, acv_qck, dcq_d, q_d, x_dqk), 2.0 * 64 * nblk_q * 64),
        "dct_quant": (
            lambda: fused_encode.dct_quant(xp, sf, cfg.error_bound),
            lambda: fused_encode._dct_quant_plain(xp, sf, cfg),
            nbytes(xp, ids_f, dcac_f), dct_flops),
        "dct_quant_qt": (
            lambda: fused_encode.dct_quant(xp, sf, cfg.error_bound, q_b),
            lambda: fused_encode._dct_quant_plain(xp, sf, cfg_qt, q_b),
            nbytes(xp, q_b, ids_g, dcac_g), dct_flops),
        "chunk_compact": (
            lambda: shuffle.compact_f32(mask_h, vals_h, capc_h),
            lambda: cp.compact_rows(mask_h, vals_h, capc_h),
            nbytes(mask_h, rows_h, cnt_h)
            + 4 * int(torch.clamp_max(cnt_h, capc_h).sum()), 0.0),
        "chunk_expand": (
            lambda: shuffle.expand(mask_i, rows_i),
            lambda: cp.expand_rows(mask_i, rows_i),
            nbytes(mask_i, acv_i) + 4 * int(mask_i.sum()), 0.0),
        "chunk_compact_unified": (
            lambda: shuffle.compact_unified(mask_j, idb_j, vals_j, 128, 128),
            lambda: shuffle._compact_unified_plain(mask_j, idb_j, vals_j, 128, 128, 128),
            nbytes(mask_j, st_j64[2], st_j64[4])
            + int(torch.clamp_max(mask_j.sum(1), 128).sum())
            + 4 * int(torch.clamp_max(((mask_j & (idb_j == 255)) & (
                torch.cumsum(mask_j.to(torch.int32), 1) <= 128)).sum(1), 128).sum()),
            0.0),
        "chunk_compact_bytes": (
            lambda: shuffle.compact_bytes(mask_k, byt_k, 128),
            lambda: cp.compact_rows(mask_k, byt_k, 128),
            nbytes(mask_k, rows_k) + int(torch.clamp_max(mask_k.sum(1), 128).sum()),
            0.0),
        "fused_encode_dpk": (
            lambda: fused_encode_dpk.fused_encode_dpk(xp, sf, cfg.error_bound),
            lambda: fused_encode_dpk._fused_encode_dpk_plain(xp, sf, cfg.error_bound),
            nbytes(xp, *l_out), dct_flops),
        "fused_decode_dpk": (
            lambda: fused_decode.fused_decode_dpk(w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad,
                                                  256, 512, cfg),
            lambda: fused_decode._fused_decode_dpk_plain(w_l, pk_l, exc_l, dc_l, ac_l, sf,
                                                         n_pad, 256, 512, cfg, None),
            nbytes(w_l, pk_l, exc_l, dc_l, ac_l, x_m), dct_flops),
        # the RELAXED instantiations on the bench array, as phase 3 checked
        # them (their operations are bf16 tensor-core FLOPs: PEAK_BF16)
        "dct_quant_verify_relaxed": (
            lambda: fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True, relaxed=True),
            lambda: fk._dct_quant_verify_plain(xp, sf, tol, n, cfg, True, relaxed=True),
            nbytes(xp, ids_ar, coef_ar), relaxed_flops),
        "dct_quant_verify_qt_relaxed": (
            lambda: fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True, q_r,
                                        relaxed=True),
            lambda: fk._dct_quant_verify_plain(xp, sf, tol, n, cfg_qt, True, q_r,
                                               relaxed=True),
            nbytes(xp, q_r, ids_aqr, vals_aqr), relaxed_flops),
        "qtable_qmax_relaxed": (
            lambda: fused_encode.qtable_qmax(xp, sf, cfg.error_bound, relaxed=True),
            lambda: fused_encode._qtable_qmax_plain(xp, sf, cfg_qt, True),
            nbytes(xp, q_r), relaxed_flops),
        "dct_quant_relaxed": (
            lambda: fused_encode.dct_quant(xp, sf, cfg.error_bound, relaxed=True),
            lambda: fused_encode._dct_quant_plain(xp, sf, cfg, relaxed=True),
            nbytes(xp, ids_fr, dcac_fr), relaxed_flops),
        "dct_quant_qt_relaxed": (
            lambda: fused_encode.dct_quant(xp, sf, cfg.error_bound, q_r, relaxed=True),
            lambda: fused_encode._dct_quant_plain(xp, sf, cfg_qt, q_r, relaxed=True),
            nbytes(xp, q_r, ids_gr, dcac_gr), relaxed_flops),
    }
    require(nblk_pad == nblk == nblk_q, "kernel shapes differ from the main path's")
    rows_out = []
    for name, (kfn, pfn, n_bytes, flops) in timed.items():
        p1 = cuda_ms(pfn, REPS)
        k1 = cuda_ms(kfn, REPS)
        k2 = cuda_ms(kfn, REPS)
        p2 = cuda_ms(pfn, REPS)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        lib_runs = ([cuda_ms(library[name], REPS) for _ in range(2)]
                    if name in library else [])
        lib_ms = sum(lib_runs) / 2 if lib_runs else None
        b_ms, b_by = bound_ms(n_bytes, flops,
                              PEAK_BF16 if name in RELAXED_KERNELS else PEAK_FP32)
        src, rep = SOURCES[name]
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": launches[MAIN_PATH[name]][name],
                         "max_abs_err": kernels[name]["max_abs_err"],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms})
        emit("kernel_time", kernel=name, card=card, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
             library=LIBRARY_NOTE.get(name), bytes=n_bytes, flops=flops,
             runs=[k1, k2], plain_runs=[p1, p2], library_runs=lib_runs,
             ptxas=ptxas.get(name))
    report["kernels"] = rows_out

    # every kernel's own device time (torch.profiler) beside the wrapper's
    # CUDA-event time of the table above
    event_ms = {r["name"]: r["ms"] for r in rows_out}
    report["kernel_device_time"] = {}
    for name, symbol in DEVICE_TIME.items():
        dev_ms = profiled_kernel_ms(timed[name][0], symbol, REPS)
        emit("kernel_device_time", card=card, kernel=name, event_ms=event_ms[name], **dev_ms)
        report["kernel_device_time"][name] = {"event_ms": event_ms[name], **dev_ms}

    # for the record, not in the table: H a second time at v1_cesm's
    # geometry (the generic chain's call), and H, J and K's lane walks on
    # the offset views of phase 3, timed as the table times
    h_bytes, j_bytes = timed["chunk_compact"][2], timed["chunk_compact_unified"][2]
    extra = {
        ("chunk_compact", "v1_cesm", "chunk_compact"): (
            lambda: shuffle.compact_f32(mask_c, vals_c, capc_c),
            lambda: cp.compact_rows(mask_c, vals_c, capc_c),
            nbytes(mask_c, rows_c, cnt_c) + 4 * int(torch.clamp_max(cnt_c, capc_c).sum()),
            lambda: torch.masked_select(vals_c, mask_c)),
        ("chunk_compact", "v1_ec, mask 1 byte off 16", "chunk_compact_lanes"): (
            lambda: shuffle.compact_f32(mask_hl, vals_h, capc_h),
            timed["chunk_compact"][1], h_bytes, library["chunk_compact"]),
        ("chunk_compact_unified", "dpk_onepass, id bytes 8 off 16",
         "chunk_compact_unified_lanes"): (
            lambda: shuffle.compact_unified(mask_j, idb_jl, vals_j, 128, 128),
            timed["chunk_compact_unified"][1], j_bytes, library["chunk_compact_unified"]),
        ("chunk_compact_bytes", "dpk_onepass, bytes 8 off 16", "chunk_compact_bytes_lanes"): (
            lambda: shuffle.compact_bytes(mask_k, byt_kl, 128),
            timed["chunk_compact_bytes"][1], timed["chunk_compact_bytes"][2],
            library["chunk_compact_bytes"]),
    }
    report["kernel_time_extra"] = []
    for (name, geometry, inst), (kfn, pfn, n_bytes, lfn) in extra.items():
        p1, k1, k2, p2 = cuda_ms(pfn, REPS), cuda_ms(kfn, REPS), cuda_ms(kfn, REPS), cuda_ms(pfn, REPS)
        lib_runs = [cuda_ms(lfn, REPS) for _ in range(2)]
        b_ms, b_by = bound_ms(n_bytes, 0.0)
        row = {"kernel": name, "geometry": geometry, "instantiation": inst,
               "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": sum(lib_runs) / 2, "bytes": n_bytes,
               "runs": [k1, k2], "plain_runs": [p1, p2], "library_runs": lib_runs,
               "ptxas": ptxas.get(inst)}
        emit("kernel_time", card=card, **row)
        report["kernel_time_extra"].append(row)

    # B, C and H-K once each, queued behind a device sleep (no host time):
    # cold, after 256 MB were written to flush the card's 50 MB of L2, and
    # warm, right after a call on the same inputs; beside the table's loop.
    # Then H, J and K's lane walks (the design before their word walks) on
    # the same inputs, launched through their entry points with word_walk
    # 0, and H's two walks at v1_cesm's geometry
    def h_launch(mask, vals, capc, word_walk):
        rows = torch.empty((mask.shape[0], capc), dtype=torch.float32, device=dev)
        cnt = torch.empty((mask.shape[0],), dtype=torch.int32, device=dev)
        m = mask.view(torch.uint8)
        return lambda: fk._launch("chunk_compact", m.data_ptr(), vals.data_ptr(), m.shape[0],
                                  m.shape[1], capc, rows.data_ptr(), cnt.data_ptr(), word_walk)

    def j_launch(word_walk):
        exc = torch.empty((mask_j.shape[0], 128), dtype=torch.uint8, device=dev)
        ac = torch.empty((mask_j.shape[0], 128), dtype=torch.float32, device=dev)
        m = mask_j.view(torch.uint8)
        return lambda: fk._launch("chunk_compact_unified", m.data_ptr(), idb_j.data_ptr(),
                                  vals_j.data_ptr(), m.shape[0], m.shape[1], 128, 128, 128,
                                  exc.data_ptr(), ac.data_ptr(), word_walk)

    def k_launch(word_walk):
        rows = torch.empty((mask_k.shape[0], 128), dtype=torch.uint8, device=dev)
        m = shuffle._mask_u8(mask_k)
        return lambda: fk._launch("chunk_compact_bytes", m.data_ptr(), byt_k.data_ptr(),
                                  m.shape[0], m.shape[1], 128, rows.data_ptr(), word_walk)

    single = {(k, "main"): timed[k][0] for k in L2_KERNELS} | {
        ("chunk_compact_lanes", "main"): h_launch(mask_h, vals_h, capc_h, 0),
        ("chunk_compact_unified_lanes", "main"): j_launch(0),
        ("chunk_compact_bytes_lanes", "main"): k_launch(0),
        ("chunk_compact", "v1_cesm"): h_launch(mask_c, vals_c, capc_c, 1),
        ("chunk_compact_lanes", "v1_cesm"): h_launch(mask_c, vals_c, capc_c, 0)}
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    report["kernel_l2"] = []
    for (name, geometry), kfn in single.items():
        kfn()
        cold = [queued_ms(kfn, flush) for _ in range(3)]
        warm = [queued_ms(kfn) for _ in range(3)]
        row = {"kernel": name, "geometry": geometry, "cold_ms": statistics.median(cold),
               "warm_ms": statistics.median(warm),
               "loop_ms": event_ms.get(name) if geometry == "main" else None,
               "cold_runs": cold, "warm_runs": warm}
        emit("kernel_l2", card=card, **row)
        report["kernel_l2"].append(row)
    del flush

    # for the record, not a claim: the one-pass kernels beside the launches
    # they could replace, in turns (each measured twice, in mirrored order)
    def f_pack_h():
        ids_c, dcac_c = fused_encode.dct_quant(xp, sf, cfg.error_bound)
        idpack.pack_ids(ids_c, n_pad, 256, 128)
        esc_c = (ids_c == 255) & (col > 0)
        shuffle.compact_f32(esc_c.reshape(-1, cw), dcac_c.reshape(-1, cw), 128)

    pairs = {
        "L fused_encode_dpk": lambda: fused_encode_dpk.fused_encode_dpk(
            xp, sf, cfg.error_bound),
        "A (verify off) + B": lambda: fk.encode_x_fused(
            xp, sf, tol, n, cfg.error_bound, 128, cw, False),
        "F + pack_ids (H) + H": f_pack_h,
        "M fused_decode_dpk": lambda: fused_decode.fused_decode_dpk(
            w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad, 256, 512, cfg),
        f"M fused_decode_dpk at tile {b_m}": lambda: fused_decode.fused_decode_dpk(
            *arr_j, sf, n_pad, b_m, cw, cfg),
        "C + D": lambda: fk.decode_fused(w_l, pk_l, exc_l, ac_l, dc_l, sf, cfg, 512, n_pad),
        "L_ref (card-only reference)": lambda: _ref.fused_encode_dpk_ref(
            xp, sf, cfg.error_bound),
        "M_ref (card-only reference)": lambda: _ref.fused_decode_dpk_ref(
            w_l, pk_l, exc_l, dc_l, ac_l, sf, n_pad, 256, 512, cfg),
    }
    order = list(pairs) + list(reversed(pairs))
    runs: dict = {k: [] for k in pairs}
    for k in order:
        runs[k].append(cuda_ms(pairs[k], REPS))
    onepass = {k: sum(v) / len(v) for k, v in runs.items()}
    emit("onepass_vs_launches", card=card, ms=onepass, runs=runs)
    report["onepass_vs_launches"] = {"card": card, "ms": onepass, "runs": runs}

    # for the record: the transforms alone as full-fp32 library matmuls at
    # 32Mi (TF32 off above); not the same function as A or D (no division,
    # bins, verify, dequantization or fmaf order), and the port never calls it
    basis = transform.dct2_basis(64, dev)
    blocks = (xp / sf).reshape(-1, 64)
    mm = {"forward": [cuda_ms(lambda: torch.matmul(blocks, basis.T), REPS) for _ in range(2)],
          "inverse": [cuda_ms(lambda: torch.matmul(coef_k, basis), REPS) for _ in range(2)]}
    transform_mm = {k: sum(v) / 2 for k, v in mm.items()}
    emit("transform_matmul_ms", card=card, ms=transform_mm, runs=mm,
         note="torch.matmul in fp32, TF32 off: a yardstick for the transform "
              "alone, not the function of A or D; the port never calls it")
    report["transform_matmul_ms"] = {"card": card, "ms": transform_mm, "runs": mm}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
