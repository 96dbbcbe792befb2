"""Where kernels A, B, C, E, F, H, J, K, L and M spend their time: each timed
whole and with one stage cut out at a time.

    python -m dctz_tpu_torch.kernels.stage_split [--csrc DIR] [--out FILE]

DIR is a csrc/ directory: this checkout's (the default), or an older tree's
unpacked from `git archive`. Each variant copies DIR, applies the text edits
of one cut to one kernel's source, builds that source alone into a library
of its own (one nvcc per variant, all at once) and times it with CUDA
events, in rounds over all variants, on the inputs the main path gives it:
32Mi samples of the bench array, EC at eb 1e-3, cw 512. A takes the bench
array with verify on (the main path's call). B takes the ids and
values of kernel A's plain version at exception capacity 128; C takes B's
plain streams cut to the decode's capacity tiers; E takes the bench array
with every 977th sample x30 (the QT input of chip_smoke.py), F and L the bench
array, M the streams B's plain version codes from it (tile 256), H the AC
escapes of F's plain version at capacity 128 (the v1_ec encode's call), J
the exception bytes of F's plain ids coded at tile 64 with their AC values
at capacity 128 (pack_ids_with_ac's call in chip_smoke.py), K the exception
mask and id bytes of the same ids coded at tile 256 at capacity 128
(chip_smoke.py's dpk_onepass call). The kernels
come in groups (A; B and C; E and F; H and J; K; L and M), each with its cut
sets, oldest first; a group's cuts are those of its first set whose every
edit finds its text. A, E and F are also timed in their RELAXED
instantiations (dct_precision="high": the bf16x3 product on the tensor
cores), whole and transform_only, by an edit that points the HIGHEST entry
point at the RELAXED instantiation ("A relaxed", "E relaxed", "F relaxed"). A cut variant computes wrong results on purpose, and
only its time is read; a design alternative (alt_ in its name) computes
the kernel's result, which is checked, and is timed beside it. Prints one
JSON line per kernel and variant. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

from . import build

N = 1 << 25
CW = 512
CAPE = 128
LAUNCHES = 20
ROUNDS = 3

A_SRC = "dct_quant_verify.cu"
B_SRC, C_SRC = "dpk_pack_compact.cu", "dpk_unpack_expand.cu"
E_SRC, F_SRC = "qtable_qmax.cu", "dct_quant.cu"
L_SRC, M_SRC = "fused_encode_dpk.cu", "fused_decode_dpk.cu"
HJ_SRC = "chunk_shuffle.cu"

#: B and C's cut sets: name -> {variant: (source, [(old text, new text),
#: ...])}. "byte_stages": B on the per-byte stages of dpk_tile.cuh, C with
#: its block-major nibble copy; "word_stages": the word-wide kernels.
BC_CUTS = {
    "byte_stages": {
        "B load_only": (B_SRC, [(
            "  __syncthreads();\n\n  select_widths(sN, sW);",
            "  __syncthreads();\n"
            "  if (sId[tid] == 1 && sN[tid] == 2) width_out[tile * BS] = 3;\n"
            "  return;\n  select_widths(sN, sW);")]),
        "B no_widths": (B_SRC, [(
            "  select_widths(sN, sW);\n", "  if (tid < BS) sW[tid] = 2;\n")]),
        "B no_pack": (B_SRC, [(
            "  pack_rows(sN, sW, packed_out + tile * BS * 128);\n", "")]),
        "B no_compact": (B_SRC, [(
            "  compact_chunks<true>(sId, sW, tile, cw, cape, cape, exc_out, ac_out, exc_cnt,\n"
            "                       ac_cnt, [&](int blk, int pos) {\n"
            "                         return vals[(blk0 + blk) * BS + pos];\n"
            "                       });\n", "")]),
        "B no_dc": (B_SRC, [(
            "dc_out[gblk] = gblk < nblk ? vals[gblk * BS] : 0.f;",
            "dc_out[gblk] = 0.f;")]),
        "C load_only": (C_SRC, [(
            "  if (tid < BS) sW[tid] = width[tile * BS + tid];\n  __syncthreads();\n",
            "  if (tid < BS) sW[tid] = width[tile * BS + tid];\n  __syncthreads();\n"
            "  if (sP[tid] == 7 && sW[tid & 63] == 9) ids_out[blk0 * BS] = 1;\n"
            "  return;\n")]),
        "C load_unpack_only": (C_SRC, [(
            "    sN[k * BS + p] = static_cast<uint8_t>(nib);\n  }\n  __syncthreads();\n",
            "    sN[k * BS + p] = static_cast<uint8_t>(nib);\n  }\n  __syncthreads();\n"
            "  if (sN[tid] == 7 && sN[tid + TILE_B] == 9) ids_out[blk0 * BS] = 1;\n"
            "  return;\n")]),
        "C unpack_no_conflict": (C_SRC, [(
            "sN[k * BS + p] = static_cast<uint8_t>(nib);",
            "sN[idx] = static_cast<uint8_t>(nib);")]),
        "C walk_no_loads": (C_SRC, [
            ("exc_rows[row * cape + rank]", "static_cast<uint8_t>(254 + (rank & 1))"),
            ("ac_rows[row * capc + arank]", "static_cast<float>(arank)")]),
        "C no_acv_store": (C_SRC, [(
            "acv_out[gi] = av;", "if (av == 1234.5f) acv_out[gi] = av;")]),
    },
    "word_stages": {
        "B no_pack": (B_SRC, [(
            "      pack_quarter(a.packed_out + (t * BS + p) * 128, s.wd[p], i, v);\n",
            "")]),
        "B no_walk": (B_SRC, [(
            "for (int u = wid; u < wk.units; u += walk::WARPS) {\n"
            "        int ecarry = 0, kcarry",
            "for (int u = wid; u < 0; u += walk::WARPS) {\n"
            "        int ecarry = 0, kcarry")]),
        "B no_kept_values": (B_SRC, [(
            "kv[k] = keep[k] ? *reinterpret_cast", "kv[k] = false ? *reinterpret_cast")]),
        "B no_zero_fill": (B_SRC, [
            ("              zero_bytes(exc_t + r * a.cape, min(ecount, a.cape), "
             "a.cape, wk, vec_e);\n", ""),
            ("              zero_floats(arow, kbase[k] + walk::byte_of(ktot, k), a.cape, "
             "wk, vec_a);\n", "")]),
        "B no_dc": (B_SRC, [(
            "a.dc_out[blk0 + tid] = s.dc[b][tid];", "a.dc_out[blk0 + tid] = 0.f;")]),
        "C walk_no_loads": (C_SRC, [
            ("rank < lim_e ? erow[rank] : 0u", "static_cast<unsigned>(254 + (rank & 1))"),
            ("rank < lim_a ? arow[rank] : 0.f", "static_cast<float>(rank)")]),
        "C no_acv_store": (C_SRC, [(
            "          *reinterpret_cast<float4*>(acv_t + o) = "
            "make_float4(0.f, 0.f, 0.f, 0.f);\n", "")]),
        "C no_walk": (C_SRC, [(
            "for (int u = wid; u < wk.units; u += walk::WARPS) {\n"
            "      int ecarry = 0, acarry",
            "for (int u = wid; u < 0; u += walk::WARPS) {\n"
            "      int ecarry = 0, acarry")]),
    },
}
#: "shared_stages": B on the stages of dpk_stages.cuh, which L shares (C as
#: in "word_stages"); no_ac_walk: the walk of the exception bytes alone, as
#: L runs it
BC_CUTS["shared_stages"] = {
    "B no_pack": (B_SRC, [(
        "    stages::pack_tile(s.st, tid, a.packed_out + t * BS * 128);\n", "")]),
    "B no_walk": (B_SRC, [(
        "    stages::walk_exceptions<true>(raw,",
        "    if (a.cw < 0) stages::walk_exceptions<true>(raw,")]),
    "B no_ac_walk": (B_SRC, [(
        "stages::walk_exceptions<true>(raw,", "stages::walk_exceptions<false>(raw,")]),
    "B no_dc": BC_CUTS["word_stages"]["B no_dc"],
} | {k: v for k, v in BC_CUTS["word_stages"].items() if k.startswith("C ")}

#: E and F's cut sets. "per_thread": one thread per DCT block on
#: common.cuh:forward_dct (E's fold in shared atomics, F's coefficients
#: through a shared row); "tiled": the register-tiled kernels of
#: dct_tile.cuh. transform_only: no epilogue (E's fold, F's bins and
#: stores), the accumulators kept alive by a store that never runs;
#: no_transform: the epilogue on the staged samples in place of the
#: product; no_store: everything but the stores (E: the CTA's fold into
#: device memory).
_ACC_SUM = ("{\n      float s = 0.f;\n#pragma unroll\n"
            "      for (int i = 0; i < 16; ++i) s += acc[i >> 2][i & 3];\n")
_STAGED = ("#pragma unroll\n    for (int i = 0; i < 16; ++i) "
           "acc[i >> 2][i & 3] = sT[tid + THREADS * i];\n")
E_NO_STORE = (E_SRC, [(
    "  if (tid < BS && sM[tid] != 0) atomicMax(&qmax_bits[tid], sM[tid]);",
    "  if (tid < BS && sM[tid] == 0x12345678) qmax_bits[tid] = 1;")])
EF_CUTS = {
    "per_thread": {
        "E transform_only": (E_SRC, [(
            "    if (k > 0 && !(c >= rmin && c <= rmax))\n"
            "      atomicMax(&sM[k], __float_as_int(fabsf(c)));",
            "    if (c == 1234.5f) sM[k] = 1;")]),
        "E no_store": E_NO_STORE,
        "F transform_only": (F_SRC, [(
            "    if (gi >= n_pad) break;",
            "    if (gi >= 0) {\n      if (sX[tid * LD] == 1234.5f) dcac_out[base] = 1.f;\n"
            "      break;\n    }")]),
        "F no_store": (F_SRC, [(
            "    ids_out[gi] = static_cast<uint8_t>(id);\n    dcac_out[gi] = v;",
            "    if (id == 7 && v == 1234.5f) dcac_out[gi] = v;")]),
    },
    "tiled": {
        "E transform_only": (E_SRC, [(
            "    fold_escapes(acc, lo, rmin, rmax, mb);",
            "    " + _ACC_SUM + "      mb[0] ^= __float_as_int(s);\n    }")]),
        "E no_transform": (E_SRC, [(
            "    tile_product<true>(sT, sBT, hi, lo, acc);\n",
            _STAGED)]),
        "E no_store": E_NO_STORE,
        "F transform_only": (F_SRC, [(
            "    store_tile<QT>(acc, base, hi, lo, n_pad, sQ, g, ids_out, dcac_out);",
            "    " + _ACC_SUM + "      if (s == 1234.5f) dcac_out[base] = s;\n    }")]),
        "F no_transform": (F_SRC, [(
            "    tile_product<true>(sT, sBT, hi, lo, acc);\n",
            _STAGED)]),
        "F no_store": (F_SRC, [
            ("if (gi < n_pad) st4(dcac_out + gi,",
             "if (v[0] + v[1] + v[2] + v[3] == 1234.5f) st4(dcac_out + gi,"),
            ("  if (gi < n_pad)\n    *reinterpret_cast<uint4*>(ids_out + gi)",
             "  if ((got[0] ^ got[1] ^ got[2] ^ got[3]) == 0x12345678u)\n"
             "    *reinterpret_cast<uint4*>(ids_out + gi)")]),
    },
}
#: "tiled_relaxed": the "tiled" cuts and the RELAXED instantiations, whole
#: and transform_only (an edit points the HIGHEST entry point at the
#: RELAXED instantiation); "tiled" now carries a marker of the sources
#: before their RELAXED instantiations (a no-op edit of text only they have)
_TILED = EF_CUTS["tiled"]
_TILED_MARK = {E_SRC: "      persistent_grid(qtable_qmax_kernel, SMEM_BYTES, tiles, cache);",
               F_SRC: "      persistent_grid(dct_quant_kernel<QT>, SMEM_BYTES, tiles, cache);"}
EF_CUTS["tiled"] = {v: (src, edits + [(_TILED_MARK[src], _TILED_MARK[src])])
                    for v, (src, edits) in _TILED.items()}
E_RELAXED = ("  return launch<false>(x, basis, sf, n, rmin, rmax, qmax_bits, stream);",
             "  return launch<true>(x, basis, sf, n, rmin, rmax, qmax_bits, stream);")
F_RELAXED = ("DCTZ_F_ENTRY(dctz_dct_quant, false)", "DCTZ_F_ENTRY(dctz_dct_quant, true)")
EF_CUTS["tiled_relaxed"] = _TILED | {
    "E relaxed": (E_SRC, [E_RELAXED]),
    "E relaxed transform_only": (E_SRC, [E_RELAXED] + _TILED["E transform_only"][1]),
    "F relaxed": (F_SRC, [F_RELAXED]),
    "F relaxed transform_only": (F_SRC, [F_RELAXED] + _TILED["F transform_only"][1]),
}
#: A's cut sets: transform_only (staging and the product into the
#: coefficient tile; no bins, screen, repair or stores); "tiled": A before
#: its RELAXED instantiations, "tiled_relaxed": in both arms
A_TRANSFORM_ONLY = (
    "            make_float4(acc[bi][0], acc[bi][1], acc[bi][2], acc[bi][3]));\n"
    "      }\n    }\n#pragma unroll\n",
    "            make_float4(acc[bi][0], acc[bi][1], acc[bi][2], acc[bi][3]));\n"
    "      }\n    }\n    if (tiles > 0) continue;\n#pragma unroll\n")
A_RELAXED = ("DCTZ_A_ENTRY(dctz_dct_quant_verify, false)",
             "DCTZ_A_ENTRY(dctz_dct_quant_verify, true)")
_A_MARK = ("template <bool QT>\n__global__ void __launch_bounds__(THREADS, MIN_CTAS)\n"
           "    dct_quant_verify_kernel(")
A_CUTS = {"tiled": {"A transform_only": (A_SRC, [A_TRANSFORM_ONLY, (_A_MARK, _A_MARK)])},
          "tiled_relaxed": {
    "A transform_only": (A_SRC, [A_TRANSFORM_ONLY]),
    "A relaxed": (A_SRC, [A_RELAXED]),
    "A relaxed transform_only": (A_SRC, [A_RELAXED, A_TRANSFORM_ONLY]),
}}
#: L and M's cut sets. "per_thread": one thread per DCT block on
#: common.cuh's transforms (the kernels the card-only references keep),
#: their transforms cut; "tiled": the kernels on dct_tile.cuh,
#: dpk_stages.cuh and dpk_walk.cuh. L: transform_only (staging and product;
#: no epilogue, escape walk or tile stages), no_transform, no_stages (no
#: widths, packing or exception walk), no_store (the sub-tile loop's DC and
#: AC-row stores). M: transform_only (the packed rows staged and the
#: product, no walk), no_transform, no_store, walk_only (the walk alone:
#: neither product nor store).
_M_STAGED = ("#pragma unroll\n      for (int i = 0; i < 16; ++i) "
             "acc[i >> 2][i & 3] = s.ct[tid + THREADS * i];\n")
M_NO_PRODUCT = ("      tile_product<false>(s.ct, s.basis, hi, lo, acc);\n", _M_STAGED)
M_NO_STORE = ("        if (bl < nb && gblk < a.nblk)\n          st4(a.out",
              "        if (bl < nb && gblk < a.nblk && acc[bi][0] == 1234.5f)\n"
              "          st4(a.out")
L_NO_STAGES = ("    // B's word-wide stages on the tile's ids\n",
               "    // B's word-wide stages on the tile's ids\n    continue;\n")
LM_CUTS = {
    "per_thread": {
        "L no_transform": (L_SRC, [(
            "    forward_dct(xs, sB, [&](int k, float c) { row[k] = c; });",
            "    for (int k = 0; k < BS; ++k) row[k] = xs[k];")]),
        "M no_transform": (M_SRC, [(
            "    inverse_dct(c, sB, sf, cr);",
            "    for (int m = 0; m < BS; ++m) cr[m] = c[m] * sf;")]),
    },
    "tiled": {
        "L transform_only": (L_SRC, [
            ("      store_subtile(acc, j, hi, lo, g, s, dc_out + t * TILE_B);",
             "      " + _ACC_SUM.replace("\n      ", "\n        ")
             + "        if (s == 1234.5f) dc_out[t * TILE_B] = s;\n      }"),
            ("      walk_escapes(s, wk, j, wid, full, valid, ac_out + t * NC * CAP, "
             "ac_cnt + t * NC);\n", ""),
            L_NO_STAGES]),
        "L no_transform": (L_SRC, [(
            "      tile_product<true>(s.t, s.bt, hi, lo, acc);\n",
            "#pragma unroll\n      for (int i = 0; i < 16; ++i) "
            "acc[i >> 2][i & 3] = s.t[tid + THREADS * i];\n")]),
        "L no_stages": (L_SRC, [L_NO_STAGES]),
        "L no_store": (L_SRC, [
            ("    if (lo == 0) dc_tile[TB * j + b] = acc[bi][0];",
             "    if (lo == 0 && acc[bi][0] == 1234.5f) dc_tile[TB * j + b] = acc[bi][0];"),
            ("      arow[rank] = q == 0 ? kv[k].x", "      if (rank < 0) arow[rank] = q == 0 ? kv[k].x"),
            ("  stages::zero_floats(arow, min(run, CAP), CAP, wk, true);\n", "")]),
        "M transform_only": (M_SRC, [(
            "        walk_words(s, a, wk, t, u0, nb, wid, ecarry, acarry);\n", "        ;\n")]),
        "M no_transform": (M_SRC, [M_NO_PRODUCT]),
        "M no_store": (M_SRC, [M_NO_STORE]),
        "M walk_only": (M_SRC, [M_NO_PRODUCT, M_NO_STORE]),
    },
}
#: H and J's cut sets. "ballot": one warp per chunk row and a ballot per 32
#: samples (the lane walk, before H and J had a word walk; its entry points
#: take no word_walk argument); "words": the word walk. scan_only: the mask
#: (J: and id) loads and the ranks, no value gather and no row stores (H
#: keeps its counts); no_store: everything but the row stores (the staging
#: is still read and zeroed); J's no_id_load: the mask words in place of the
#: id words (no escapes, so no AC values either).
#: the ballot set's marker (unchanged text that only the older source has,
#: so that the set does not match a source whose compact_row K alone runs)
_OLD_H = ("  compact_row(mask, vals, nc, cw, capc, rows, counts);\n",
          "  compact_row(mask, vals, nc, cw, capc, rows, counts);\n")
_OLD_FILL = ("  for (int q = min(count, capc) + lane; q < capc; q += 32) out[q] = T(0);\n",
             "")
_OLD_J_FILL = ("  for (int q = min(ecount, cape) + lane; q < cape; q += 32) eo[q] = 0;\n"
               "  for (int q = min(acount, capc) + lane; q < capc; q += 32) ao[q] = 0.f;\n",
               "")
_OLD_J_EXC = "    if (on && rank < cape) eo[rank] = static_cast<uint8_t>(id);\n"
_OLD_J_AC = "    if (esc && arank < capc) ao[arank] = v[e];\n"
_H_SCATTER = "      if (c != 0 && r < a.capc) {\n"
_H_STORE = "    store_span(st, pad, dst, rows * a.capc, tid);\n"
_EXC_STORE = "    store_span(se, pe, edst, rows * a.cape, tid);\n"
_J_STORES = _EXC_STORE + "    store_span(sa, pa, adst, rows * a.capc, tid);\n"
#: J's walk as the template it shares with K (compact_exceptions<AC>)
_J_STORES_AC = _EXC_STORE + "    if (AC) store_span(sa, pa, adst, rows * a.capc, tid);\n"
_EXC_BYTE = ("        if (r < a.cape) erow[r] = static_cast<uint8_t>(id);\n",
             "        if (r == -12345) a.exc[0] = static_cast<uint8_t>(id);\n")
_AC_VALUE = ("          if (ar < a.capc) arow[ar] = v[b];\n",
             "          if (ar == -12345) a.ac[0] = 0.f;\n")
_NO_ID_LOAD = ("    i = load16(a.idb + ld.off, ok);\n", "    i = m;\n")


#: the stores of words::store_span (H's rows, J's exception and AC rows)
#: made to depend on a value that does not occur: the staging is still read
#: and zeroed
_NO_STORE = (HJ_SRC, [
    ("    __stcs(d4 + i, s4[i]);\n", "    if (s4[i].x == 0x9e3779b9u) __stcs(d4 + i, s4[i]);\n"),
    ("    dst[tid] = st[pad + tid];\n",
     "    if (st[pad + tid] == T(77)) dst[tid] = st[pad + tid];\n"),
    ("    dst[m] = st[pad + m];\n", "    if (st[pad + m] == T(77)) dst[m] = st[pad + m];\n")])


HJ_CUTS = {
    "ballot": {
        "H scan_only": (HJ_SRC, [_OLD_H, (
            "    if (on && rank < capc) out[rank] = v[e];\n",
            "    if (on && rank == -12345) out[0] = T(0);\n"), _OLD_FILL]),
        "H no_store": (HJ_SRC, [_OLD_H, (
            "    if (on && rank < capc) out[rank] = v[e];\n",
            "    if (on && rank < capc && v[e] == T(123)) out[rank] = v[e];\n"), _OLD_FILL]),
        "J scan_only": (HJ_SRC, [
            (_OLD_J_EXC, "    if (on && rank == -12345) eo[0] = static_cast<uint8_t>(id);\n"),
            (_OLD_J_AC, "    if (esc && arank == -12345) ao[0] = 0.f;\n"), _OLD_J_FILL]),
        "J no_store": (HJ_SRC, [
            (_OLD_J_EXC, "    if (on && rank < cape && id == 1234) eo[rank] = 0;\n"),
            (_OLD_J_AC, "    if (esc && arank < capc && v[e] == 1234.5f) ao[arank] = v[e];\n"),
            _OLD_J_FILL]),
        "J no_id_load": (HJ_SRC, [(
            "    const int id = (on && rank < need) ? ib[e] : 0;\n",
            "    const int id = (on && rank < need) ? m[e] : 0;\n")]),
    },
    "words": {
        "H scan_only": (HJ_SRC, [
            (_H_SCATTER, "      if (c != 0 && r == -12345) {\n"), (_H_STORE, "")]),
        "H no_store": _NO_STORE,
        "J scan_only": (HJ_SRC, [_EXC_BYTE, _AC_VALUE, (_J_STORES, "")]),
        "J no_store": _NO_STORE,
        "J no_id_load": (HJ_SRC, [_NO_ID_LOAD]),
    },
}
#: "exceptions": J's walk as the template compact_exceptions<AC>, which K
#: shares (H's cuts as in "words")
HJ_CUTS["exceptions"] = HJ_CUTS["words"] | {
    "J scan_only": (HJ_SRC, [_EXC_BYTE, _AC_VALUE, (_J_STORES_AC, "")])}
#: K's cut sets. "ballot": K on the lane walk's compact_row, before K had a
#: word walk (its entry point takes no word_walk argument; the marker is
#: the old kernel's signature); "exceptions": K as J's template without
#: its AC half. scan_only: the mask and byte loads and the ranks, no byte
#: stores to the staging or the rows; no_value_load: the mask words in
#: place of the byte words (the lane walk: each kept byte its position);
#: no_store: everything but the row stores
_OLD_K = ("    chunk_compact_bytes_kernel(const uint8_t* __restrict__ mask,\n",
          "    chunk_compact_bytes_kernel(const uint8_t* __restrict__ mask,\n")
_OLD_KEEP = "    if (on && rank < capc) out[rank] = v[e];\n"
K_CUTS = {
    "ballot": {
        "K scan_only": (HJ_SRC, [_OLD_K, (
            _OLD_KEEP, "    if (on && rank == -12345) out[0] = T(0);\n"), _OLD_FILL]),
        "K no_value_load": (HJ_SRC, [_OLD_K, (
            _OLD_KEEP, "    if (on && rank < capc) out[rank] = static_cast<T>(e);\n")]),
        "K no_store": (HJ_SRC, [_OLD_K, (
            _OLD_KEEP, "    if (on && rank < capc && v[e] == T(123)) out[rank] = v[e];\n"),
            _OLD_FILL]),
    },
    "exceptions": {
        "K scan_only": (HJ_SRC, [_EXC_BYTE, (_EXC_STORE, "")]),
        "K no_value_load": (HJ_SRC, [_NO_ID_LOAD]),
        "K no_store": _NO_STORE,
    },
}
#: design alternatives of J and K's word walk, timed beside it: unlike a
#: cut, each computes the kernel's result. alt_gated_ids: an id word loaded
#: only where its mask word, fetched a step earlier, is not zero
#: (alt_gated_ids_2: two steps earlier, the mask words three steps ahead);
#: alt_3_ahead: the words of three steps in flight, not two; alt_4_ctas:
#: __launch_bounds__ for 4 CTAs per SM (64 registers); alt_ballot_test: H's
#: ballot in place of the scan where no lane holds two exceptions (J and
#: K); alt_ballot_ranks: ranks from five ballots of the count's bits in
#: place of the scan
_FETCH = ("  Cursor ld(q, a.cw, wid);\n"
          "  const auto fetch = [&](uint4& m, uint4& i) {\n"
          "    const bool ok = ld.valid(groups, nc);\n"
          "    m = load16(a.mask + ld.off, ok);\n"
          "    i = load16(a.idb + ld.off, ok);\n"
          "    ld.next(q, a.cw);\n"
          "  };\n"
          "  uint4 m0, i0, m1, i1;\n"
          "  fetch(m0, i0);\n"
          "  fetch(m1, i1);\n")
_GATED = ("  Cursor ld(q, a.cw, wid), li(q, a.cw, wid);\n"
          "  const auto fetch_m = [&]() {\n"
          "    const uint4 m = load16(a.mask + ld.off, ld.valid(groups, nc));\n"
          "    ld.next(q, a.cw);\n"
          "    return m;\n"
          "  };\n"
          "  const auto fetch_i = [&](const uint4& m) {\n"
          "    const uint4 i = load16(a.idb + li.off, (m.x | m.y | m.z | m.w) != 0u);\n"
          "    li.next(q, a.cw);\n"
          "    return i;\n"
          "  };\n")
_NEXT = "      m0 = m1;\n      i0 = i1;\n      fetch(m1, i1);\n"
_INC = "        const unsigned inc = q.scan(static_cast<unsigned>(c | na << 16));\n"
_SCAN = ("      // exception counts in the low half, escape counts in the high half\n"
         + _INC[2:] +
         "      const int before_e = static_cast<int>(inc & 0xffffu) - c;\n"
         "      const int before_a = static_cast<int>(inc >> 16) - na;\n"
         "      const int tot_e = static_cast<int>(q.total(inc) & 0xffffu);\n")
_SCANNED = (_INC + "        before_e = static_cast<int>(inc & 0xffffu) - c;\n"
            "        before_a = static_cast<int>(inc >> 16) - na;\n"
            "        tot_e = static_cast<int>(q.total(inc) & 0xffffu);\n")
_BALLOT_TEST = (HJ_SRC, [(_SCAN, (
    "      int before_e, before_a, tot_e;\n"
    "      if (__any_sync(FULL, c > 1)) {\n" + _SCANNED + "      } else {\n"
    "        const unsigned below = lanes_below();\n"
    "        const unsigned be = __ballot_sync(FULL, c != 0) & q.segmask;\n"
    "        before_e = __popc(be & below);\n"
    "        before_a = __popc(__ballot_sync(FULL, na != 0) & q.segmask & below);\n"
    "        tot_e = __popc(be);\n"
    "      }\n"))])
HJ_CUTS["exceptions"]["J alt_ballot_test"] = _BALLOT_TEST
K_CUTS["exceptions"] |= {
    "K alt_gated_ids": (HJ_SRC, [
        (_FETCH, _GATED + "  uint4 m0 = fetch_m();\n  uint4 m1 = fetch_m();\n"
         "  uint4 i0 = fetch_i(m0);\n"),
        (_NEXT, "      m0 = m1;\n      m1 = fetch_m();\n      i0 = fetch_i(m0);\n")]),
    "K alt_gated_ids_2": (HJ_SRC, [
        (_FETCH, _GATED + "  uint4 m0 = fetch_m();\n  uint4 m1 = fetch_m();\n"
         "  uint4 m2 = fetch_m();\n  uint4 i0 = fetch_i(m0);\n  uint4 i1 = fetch_i(m1);\n"),
        (_NEXT, "      m0 = m1;\n      m1 = m2;\n      i0 = i1;\n      m2 = fetch_m();\n"
         "      i1 = fetch_i(m1);\n")]),
    "K alt_3_ahead": (HJ_SRC, [
        ("  uint4 m0, i0, m1, i1;\n  fetch(m0, i0);\n  fetch(m1, i1);\n",
         "  uint4 m0, i0, m1, i1, m2, i2;\n  fetch(m0, i0);\n  fetch(m1, i1);\n"
         "  fetch(m2, i2);\n"),
        (_NEXT, "      m0 = m1;\n      i0 = i1;\n      m1 = m2;\n      i1 = i2;\n"
         "      fetch(m2, i2);\n")]),
    "K alt_4_ctas": (HJ_SRC, [(
        "__launch_bounds__(words::THREADS, 3)\n    chunk_compact_bytes_kernel",
        "__launch_bounds__(words::THREADS, 4)\n    chunk_compact_bytes_kernel")]),
    "K alt_ballot_test": _BALLOT_TEST,
    "K alt_ballot_ranks": (HJ_SRC, [(_SCAN, (
        "      int before_e, before_a, tot_e;\n"
        "      if (AC) {\n" + _SCANNED + "      } else {\n"
        "        const unsigned below = lanes_below();\n"
        "        before_e = before_a = tot_e = 0;\n"
        "#pragma unroll\n"
        "        for (int k = 0; k < 5; ++k) {\n"
        "          const unsigned bk = __ballot_sync(FULL, (c >> k) & 1) & q.segmask;\n"
        "          before_e += __popc(bk & below) << k;\n"
        "          tot_e += __popc(bk) << k;\n"
        "        }\n"
        "      }\n"))]),
}
#: the kernel groups: group -> (the sources timed whole, the cut sets)
GROUPS = {"A": ((A_SRC,), A_CUTS), "B, C": ((B_SRC, C_SRC), BC_CUTS),
          "E, F": ((E_SRC, F_SRC), EF_CUTS),
          "H, J": ((HJ_SRC, HJ_SRC), HJ_CUTS), "K": ((HJ_SRC,), K_CUTS),
          "L, M": ((L_SRC, M_SRC), LM_CUTS)}



def cut_sets(csrc: pathlib.Path) -> dict:
    """{group: (name, cuts)}: each group's first cut set whose every edit
    finds its text in the sources under csrc."""
    out = {}
    for group, (_srcs, sets) in GROUPS.items():
        for name, cuts in sets.items():
            if all(old in (csrc / src).read_text()
                   for src, edits in cuts.values() for old, _new in edits):
                out[group] = (name, cuts)
                break
        else:
            raise SystemExit(f"no cut set of group {group} applies to {csrc}")
    return out


def _build(csrc: pathlib.Path, sets: dict, root: pathlib.Path) -> dict:
    """One library per variant (each kernel whole, and each cut), built by
    parallel nvcc processes: {variant: (source, path)}."""
    variants = {}
    for group, (name, cuts) in sets.items():
        srcs = GROUPS[group][0]
        variants.update({f"{k} whole": (src, []) for k, src in zip(group.split(", "), srcs)})
        variants.update(cuts)
    libs, procs = {}, []
    for i, (name, (src, edits)) in enumerate(variants.items()):
        d = root / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        text = (d / src).read_text()
        for old, new in edits:
            text = text.replace(old, new, 1)
        (d / src).write_text(text)
        lib = d / "lib.so"
        procs.append((name, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs[name] = (src, lib)
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    return libs


def _inputs(torch):
    """Kernel A's, B's, C's, E's, F's, H's, J's, K's, L's and M's arguments at
    the main path's shapes (B, C, H, J, K and M from the plain versions on
    the card), by kernel letter. H, J and K's end in the word_walk flag
    (1). Also the outputs of each kernel with design alternatives (J's
    and K's), by letter."""
    from ..config import CodecConfig
    from ..core import quantize as qz
    from ..core import transform
    from ..ops import dpk_fuse as fk
    from ..ops import fused_encode, idpack
    from ..utils.bench_data import climate_formula_np
    from .. import api

    dev = torch.device("cuda")
    cfg = CodecConfig(error_bound=1e-3, container="v2", ids_codec="device", verify=True)
    x = torch.from_numpy(climate_formula_np(N)).to(dev)
    sf, _ = api._stats_device(x, N, cfg.sf_adj)
    tol = fused_encode.tolerance(x, N, cfg.error_bound)
    ids, vals, _ok = fk._dct_quant_verify_plain(x, sf, tol, N, cfg, True)
    nblk = N // 64
    ids_a = torch.empty((nblk, 64), dtype=torch.uint8, device=dev)
    vals_a = torch.empty((nblk, 64), dtype=torch.float32, device=dev)
    ok_a = torch.empty((-(-N // fk.CTA_N),), dtype=torch.int32, device=dev)
    tol1 = tol.reshape(1).to(torch.float32).contiguous()
    width, packed, exc, exc_n, ac, ac_n, dc_b = fk._dpk_pack_compact_plain(ids, vals, N, CAPE)
    tier = lambda peak: next(c for c in (32, 64, 128, CW) if c >= min(peak, CW))  # noqa: E731
    cape, capc = tier(int(exc_n.max())), tier(int(ac_n.max()))
    exc_t, ac_t = exc[:, :cape].contiguous(), ac[:, :capc].contiguous()
    t = -(-nblk // 256)  # tiles of 256 blocks
    cpt = 16384 // CW
    outs_b = [torch.empty(s, dtype=d, device=dev) for s, d in (
        ((t, 64), torch.uint8), ((t * 64, 128), torch.uint8), ((t * cpt, CAPE), torch.uint8),
        ((t * cpt, CAPE), torch.float32), ((t * cpt,), torch.int32),
        ((t * cpt,), torch.int32), ((t * 256,), torch.float32))]
    b_args = (ids.data_ptr(), vals.data_ptr(), nblk, N, CW, CAPE,
              *(o.data_ptr() for o in outs_b))
    ids_c = torch.empty((nblk, 64), dtype=torch.uint8, device=dev)
    acv_c = torch.empty((nblk, 64), dtype=torch.float32, device=dev)
    c_args = (width.data_ptr(), packed.data_ptr(), exc_t.data_ptr(), ac_t.data_ptr(),
              nblk, exc_t.shape[0], N, CW, cape, capc, ids_c.data_ptr(), acv_c.data_ptr())
    basis = transform.dct2_basis(64, dev)
    xq = x.clone()
    xq[::977] *= 30.0
    sf_q, _ = api._stats_device(xq, N, cfg.sf_adj)
    sf1, sf_q1 = sf.reshape(1).contiguous(), sf_q.reshape(1).contiguous()
    w, rmin, rmax = qz._geometry(cfg)
    bits = torch.zeros((64,), dtype=torch.int32, device=dev)
    e_args = (xq.data_ptr(), basis.data_ptr(), sf_q1.data_ptr(), N, rmin, rmax,
              bits.data_ptr())
    ids_f = torch.empty((nblk, 64), dtype=torch.uint8, device=dev)
    dcac_f = torch.empty((nblk, 64), dtype=torch.float32, device=dev)
    f_args = (x.data_ptr(), basis.data_ptr(), sf1.data_ptr(), N, rmin, rmax, w,
              ids_f.data_ptr(), dcac_f.data_ptr())
    a_args = (x.data_ptr(), basis.data_ptr(), sf1.data_ptr(), tol1.data_ptr(), N, N, rmin,
              rmax, w, 1, ids_a.data_ptr(), vals_a.data_ptr(), ok_a.data_ptr(), None)
    outs_l = [torch.empty_like(o) for o in outs_b]
    l_args = (x.data_ptr(), basis.data_ptr(), sf1.data_ptr(), N, rmin, rmax, w,
              *(o.data_ptr() for o in outs_l))
    out_m = torch.empty((N,), dtype=torch.float32, device=dev)
    m_args = (width.data_ptr(), packed.data_ptr(), exc_t.data_ptr(), ac_t.data_ptr(),
              dc_b.data_ptr(), basis.data_ptr(), sf1.data_ptr(), None, nblk,
              exc_t.shape[0], ac_t.shape[0], 256, CW, cape, capc, w, rmin, rmax, 1.0, 0,
              out_m.data_ptr())
    ids_fp, dcac_fp = fused_encode._dct_quant_plain(x, sf, cfg)
    nc = N // CW
    mask_h = ((ids_fp == 255) & (torch.arange(64, device=dev) > 0)).view(torch.uint8)
    rows_h = torch.empty((nc, CAPE), dtype=torch.float32, device=dev)
    cnt_h = torch.empty((nc,), dtype=torch.int32, device=dev)
    h_args = (mask_h.data_ptr(), dcac_fp.data_ptr(), nc, CW, CAPE, rows_h.data_ptr(),
              cnt_h.data_ptr(), 1)
    _w, _pk, ids_64, mask_64 = idpack._code_tiles(ids_fp, N, 64)
    mask_j, idb_j = mask_64.view(torch.uint8), ids_64.to(torch.uint8)
    exc_j = torch.empty((nc, CAPE), dtype=torch.uint8, device=dev)
    ac_j = torch.empty((nc, CAPE), dtype=torch.float32, device=dev)
    j_args = (mask_j.data_ptr(), idb_j.data_ptr(), dcac_fp.data_ptr(), nc, CW, CAPE, CAPE,
              CAPE, exc_j.data_ptr(), ac_j.data_ptr(), 1)
    _w, _pk, ids_256, mask_256 = idpack._code_tiles(ids_fp, N, 256)
    mask_k, byt_k = mask_256.view(torch.uint8), ids_256.to(torch.uint8)
    rows_k = torch.empty((nc, CAPE), dtype=torch.uint8, device=dev)
    k_args = (mask_k.data_ptr(), byt_k.data_ptr(), nc, CW, CAPE, rows_k.data_ptr(), 1)
    keep = (ids_a, vals_a, ok_a, tol1, ids, vals, width, packed, exc_t, ac_t, dc_b, outs_b, ids_c, acv_c, basis, xq,
            sf1, sf_q1, bits, ids_f, dcac_f, outs_l, out_m, ids_fp, dcac_fp, mask_h, rows_h,
            cnt_h, mask_j, idb_j, exc_j, ac_j, mask_k, byt_k, rows_k)
    return {"A": ("dctz_dct_quant_verify", a_args),
            "B": ("dctz_dpk_pack_compact", b_args),
            "C": ("dctz_dpk_unpack_expand", c_args),
            "E": ("dctz_qtable_qmax", e_args),
            "F": ("dctz_dct_quant", f_args),
            "H": ("dctz_chunk_compact", h_args),
            "J": ("dctz_chunk_compact_unified", j_args),
            "K": ("dctz_chunk_compact_bytes", k_args),
            "L": ("dctz_fused_encode_dpk", l_args),
            "M": ("dctz_fused_decode_dpk", m_args)}, {"cape": cape, "capc": capc}, keep, {
                "J": (exc_j, ac_j), "K": (rows_k,)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(build.CSRC))
    ap.add_argument("--out", default="build/stage_split.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stage_split: CUDA is not available", file=sys.stderr)
        return 2
    csrc = pathlib.Path(args.csrc).resolve()
    sets = cut_sets(csrc)
    set_of = {k: name for group, (name, _c) in sets.items() for k in group.split(", ")}
    libs = _build(csrc, sets, build.BUILD_DIR / "stage_split")
    calls, caps, _keep, outs = _inputs(torch)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    for name, (_src, path) in libs.items():
        sym, call_args = calls[name[0]]
        argtypes = build.SIGNATURES[sym]
        if name[0] in "HJK" and set_of[name[0]] == "ballot":  # no word_walk flag
            call_args, argtypes = call_args[:-1], argtypes[:-2] + argtypes[-1:]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = (fn, call_args)

    def run(name):
        fn, call_args = fns[name]
        rc = fn(*call_args, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed with error {rc}")

    times: dict = {name: [] for name in fns}
    for name in fns:
        run(name)
    # a design alternative must compute what the whole kernel computes
    for name in fns:
        if " alt_" in name:
            run(name[0] + " whole")
            want = [t.clone() for t in outs[name[0]]]
            run(name)
            if not all(torch.equal(t, w) for t, w in zip(outs[name[0]], want)):
                raise RuntimeError(f"{name}: differs from {name[0]} whole")
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for name in fns:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(LAUNCHES):
                run(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / LAUNCHES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    for name, ts in times.items():
        row = {"variant": name, "ms_mean": sum(ts) / len(ts), "ms_min": min(ts),
               "runs": ts, "cut_set": set_of[name[0]], "csrc": str(csrc), "card": card,
               "launches_per_run": LAUNCHES, **caps}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
