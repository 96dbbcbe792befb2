#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dctz_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out build/chip_smoke.json]

Drives the port's main path once at the benchmark's size (32Mi float32
elements, the bench.py configuration: EC, eb 1e-3, v2 container, DPK ids,
verify on, monolithic) and checks it. Phases, each printed as one JSON line:

  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build:  the four CUDA kernels compiled from dctz_tpu_torch/csrc
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes: B and C byte-equal, A within 1e-5 of ids, D within
     32 ulp of sf
  4. end to end: compress and decompress through the public API on the
     card, with every kernel's launch counter > 0, the pointwise bound
     satisfied, the ratio within 0.1% of the plain (CPU) path's, and each
     path's container decoded by the other within the bound
  5. times: compress and decompress GB/s (median of warm runs), their
     split into stages, a torch.profiler pass over one call of each (device
     busy and idle share), and each kernel's time beside its plain
     version's (CUDA events)

Any failed check raises, and the script exits non-zero without a result.
Without CUDA it exits 2 at once. The last line is the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

N = 1 << 25  # elements: 128 MB of float32, the benchmark's size
REPS = 3
A_ID_MISMATCH_MAX = 1e-5
D_ULPS = 32
RATIO_REL_TOL = 1e-3


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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


def wall_s(fn, reps: int) -> float:
    """Median wall seconds of fn() over warm runs ending in a synchronize."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def profile_once(dz, x_np, cfg, blob, card) -> dict:
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
        emit("profile", card=card, op=name, **out[name])
    return out


def max_abs_diff(pairs) -> float:
    """Largest |a - b| over pairs of equal-shape tensors (any dtype)."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in pairs)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the full JSON report is written")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    import dctz_tpu_torch as dz
    from dctz_tpu_torch import api
    from dctz_tpu_torch.core import container as ct
    from dctz_tpu_torch.core import quantize as qz
    from dctz_tpu_torch.kernels import build
    from dctz_tpu_torch.ops import dpk_fuse as fk
    from dctz_tpu_torch.ops import fused_encode
    from dctz_tpu_torch.utils.bench_data import climate_formula_np

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
    ptxas = [ln.strip() for ln in build.PTXAS_LOG.read_text().splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit("build", seconds=round(build.last_build_s, 3), library=str(build.LIB_PATH),
         ptxas=ptxas)
    report["build"] = {"seconds": build.last_build_s, "ptxas": ptxas}

    # 3. kernels against their plain versions, at the main path's shapes
    cfg = dz.CodecConfig(mode="ec", error_bound=1e-3, container="v2",
                         ids_codec="device", verify=True, segment_elems=0)
    x_np = climate_formula_np(N)
    n = x_np.size
    dev = torch.device("cuda")
    x = torch.from_numpy(x_np).to(dev)
    n_pad = n + (-n) % 1024
    xp = torch.nn.functional.pad(x, (0, n_pad - n))
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
    outs_p = fk._dpk_pack_compact_plain(ids_k, coef_k, n_pad, cape_k)
    torch.cuda.synchronize()
    names = ["width", "packed", "exc", "exc_counts", "ac", "ac_counts", "dc"]
    for a, b, nm in zip(outs_k, outs_p, names):
        require(a.shape == b.shape and a.dtype == b.dtype, f"B: {nm} shape/dtype")
        require(torch.equal(a, b), f"B: {nm} differs from the plain version")
    err_b = max_abs_diff(zip(outs_k, outs_p))
    emit("kernel_check", kernel="dpk_pack_compact", byte_equal=True,
         max_abs_err=err_b, overflow=bool((outs_k[3] > cape_k).any()))
    kernels["dpk_pack_compact"] = {"max_abs_err": err_b}

    blob0 = dz.compress(x_np, config=cfg, device="cuda")
    header, streams, _q, _cb = ct.parse_v2(blob0)
    (width, rows, exc, dc, ac), (n_stream, _tb, cw_d, _cfg) = api._dpk_decode_prep(
        header, streams
    )
    d_in = [torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)
            for a in (width, rows, exc)]
    dc_d = api._combine_planes(torch.from_numpy(np.array(dc)).to(dev))
    ac_d = api._combine_planes(torch.from_numpy(np.array(ac)).to(dev)).contiguous()
    sf_d = torch.tensor(header.scaling_factor, dtype=torch.float32, device=dev)
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

    hdr_cfg = api._header_config(header)
    x_dk = fk.dequant_idct(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream)
    x_dp = fk._dequant_idct_plain(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream)
    torch.cuda.synchronize()
    err_d = (x_dk - x_dp).abs().max().item()
    lim_d = D_ULPS * 2.0 ** -23 * header.scaling_factor
    emit("kernel_check", kernel="dequant_idct", max_abs_err=err_d, limit=lim_d)
    require(err_d <= lim_d, f"D: {err_d} > {lim_d}")
    kernels["dequant_idct"] = {"max_abs_err": err_d}

    # 4. end to end through the public API; the counters count this run only
    fk.reset_launches()
    blob = dz.compress(x_np, config=cfg, device="cuda")
    y = dz.decompress(blob, device="cuda")
    launches = dict(fk.LAUNCHES)
    ev = dz.evaluate(x_np, y, cfg.error_bound)
    ratio = x_np.nbytes / len(blob)
    emit("end_to_end", n=n, bytes_in=x_np.nbytes, bytes_out=len(blob), ratio=ratio,
         launches=launches, psnr_db=ev["psnr_db"], max_rel_err=ev["max_rel_err"],
         bound_satisfied=ev["bound_satisfied"])
    require(all(v > 0 for v in launches.values()), f"a kernel did not launch: {launches}")
    require(ev["bound_satisfied"], "pointwise bound violated")

    t0 = time.perf_counter()
    blob_cpu = dz.compress(x_np, config=cfg, device="cpu")
    t_cpu_c = time.perf_counter() - t0
    ratio_cpu = x_np.nbytes / len(blob_cpu)
    y_gpu_of_cpu = dz.decompress(blob_cpu, device="cuda")
    t0 = time.perf_counter()
    y_cpu_of_gpu = dz.decompress(blob, device="cpu")
    t_cpu_d = time.perf_counter() - t0
    tolx = cfg.error_bound * float(x_np.max() - x_np.min())
    e1 = float(np.abs(y_gpu_of_cpu - x_np).max())
    e2 = float(np.abs(y_cpu_of_gpu - x_np).max())
    emit("cross_check", ratio_plain=ratio_cpu, ratio_rel_diff=ratio / ratio_cpu - 1.0,
         gpu_decodes_plain_max_err=e1, plain_decodes_gpu_max_err=e2, bound=tolx,
         plain_compress_s=t_cpu_c, plain_decompress_s=t_cpu_d)
    require(abs(ratio / ratio_cpu - 1.0) <= RATIO_REL_TOL, "ratio differs from the plain path")
    require(e1 <= tolx and e2 <= tolx, "cross decode violates the bound")
    report["end_to_end"] = {"ratio": ratio, "ratio_plain": ratio_cpu,
                            "launches": launches, "evaluate": ev}

    # 5. times (the card's name and power limit go beside every number)
    t_c = wall_s(lambda: dz.compress(x_np, config=cfg, device="cuda"), REPS)
    t_d = wall_s(lambda: dz.decompress(blob, device="cuda"), REPS)
    gbs_c, gbs_d = x_np.nbytes / t_c / 1e9, x_np.nbytes / t_d / 1e9
    emit("throughput", card=card, compress_gb_s=gbs_c, decompress_gb_s=gbs_d,
         compress_s=t_c, decompress_s=t_d, reps=REPS)
    from dctz_tpu_torch.utils.timing import StageTimer

    tc, td = StageTimer(sync=True), StageTimer(sync=True)
    with tc:
        dz.compress(x_np, config=cfg, device="cuda", timer=tc)
    with td:
        dz.decompress(blob, device="cuda", timer=td)
    emit("stages", card=card, compress=tc.report(x_np.nbytes),
         decompress=td.report(x_np.nbytes))
    report["stages"] = {"compress": tc.report(x_np.nbytes),
                        "decompress": td.report(x_np.nbytes)}
    report["profile"] = profile_once(dz, x_np, cfg, blob, card)

    timed = {
        "dct_quant_verify": (
            lambda: fk.dct_quant_verify(xp, sf, tol, n, cfg.error_bound, True),
            lambda: fk._dct_quant_verify_plain(xp, sf, tol, n, cfg, True)),
        "dpk_pack_compact": (
            lambda: fk.dpk_pack_compact(ids_k, coef_k, n_pad, cape_k, cw),
            lambda: fk._dpk_pack_compact_plain(ids_k, coef_k, n_pad, cape_k)),
        "dpk_unpack_expand": (
            lambda: fk.dpk_unpack_expand(*d_in, ac_d, nblk, n_stream, cw_d),
            lambda: fk._dpk_unpack_expand_plain(*d_in, ac_d, nblk, n_stream, cw_d)),
        "dequant_idct": (
            lambda: fk.dequant_idct(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream),
            lambda: fk._dequant_idct_plain(ids_ck, acv_ck, dc_d, sf_d, hdr_cfg, n_stream)),
    }
    sources = {
        "dct_quant_verify": ("dctz_tpu_torch/csrc/dct_quant_verify.cu", "dctz_tpu/ops/dpk_fuse.py:782"),
        "dpk_pack_compact": ("dctz_tpu_torch/csrc/dpk_pack_compact.cu", "dctz_tpu/ops/dpk_fuse.py:782"),
        "dpk_unpack_expand": ("dctz_tpu_torch/csrc/dpk_unpack_expand.cu", "dctz_tpu/ops/dpk_fuse.py:1041"),
        "dequant_idct": ("dctz_tpu_torch/csrc/dequant_idct.cu", "dctz_tpu/ops/dpk_fuse.py:1041"),
    }
    rows_out = []
    for name, (kfn, pfn) in timed.items():
        p1 = cuda_ms(pfn, REPS)
        k1 = cuda_ms(kfn, REPS)
        k2 = cuda_ms(kfn, REPS)
        p2 = cuda_ms(pfn, REPS)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        src, rep = sources[name]
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                         "launches": launches[name],
                         "max_abs_err": kernels[name]["max_abs_err"],
                         "ms": ms, "plain_ms": plain_ms})
        emit("kernel_time", kernel=name, card=card, ms=ms, plain_ms=plain_ms,
             runs=[k1, k2], plain_runs=[p1, p2])
    report["kernels"] = rows_out
    report["throughput"] = {"compress_gb_s": gbs_c, "decompress_gb_s": gbs_d, "card": card}

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
