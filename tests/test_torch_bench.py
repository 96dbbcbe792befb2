"""The port's benchmark (dctz_tpu_torch/bench.py) on the CPU: the rehearsal
end to end, its default-path container against dctz_tpu's under the oracle,
its overlap fraction and pipelined model against bench.py's own code, and
the exit without a card.

bench.py is never imported here: importing it turns on jax's persistent
compilation cache for the whole process (bench.py:59-70). Its functions are
read from its source with ast instead."""

import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_oracle import assert_byte_equal, frames_of, oracle, ref_arithmetic  # noqa: F401

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_CPU = 65536
#: the compact line's keys (dctz_tpu_torch.bench.run's "last_line")
LAST_KEYS = {"metric", "value", "unit", "vs_baseline", "compress_gbps",
             "decompress_gbps", "ratio", "bound_satisfied", "host_codec",
             "platform", "card", "n"}


def _bench_py() -> ast.Module:
    return ast.parse((ROOT / "bench.py").read_text())


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _expr(node: ast.expr) -> ast.expr:
    """node without an outer round(v, k): the port reports unrounded."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "round"):
        return node.args[0]
    return node


def _eval(node: ast.expr, env: dict):
    return eval(compile(ast.Expression(_expr(node)), "bench.py", "eval"), dict(env))


def _assigned(fn: ast.FunctionDef, name: str) -> ast.expr:
    """The expression bench.py's function fn assigns to name."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == name):
            return node.value
    raise LookupError(name)


def _returned(fn: ast.FunctionDef, key: str) -> ast.expr:
    """The expression under `key` in the dict that fn returns."""
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    for k, v in zip(ret.value.keys, ret.value.values):
        if isinstance(k, ast.Constant) and k.value == key:
            return v
    raise LookupError(key)


def _run_bench(tmp_path, *args, env=None):
    out = tmp_path / "bench.json"
    res = subprocess.run(
        [sys.executable, "-m", "dctz_tpu_torch.bench", "--out", str(out), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, **(env or {})))
    return res, out


def test_cpu_rehearsal_end_to_end(tmp_path):
    """--device cpu at a small n: exit 0, a last line of at most 1,000
    bytes with every summary key, platform "cpu", no card metric, the bound
    satisfied, and the full record at --out with every section."""
    res, out = _run_bench(tmp_path, "--device", "cpu", "--n", str(N_CPU))
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    last = lines[-1]
    assert len(last.encode()) <= 1000
    summary = json.loads(last)
    assert set(summary) == LAST_KEYS
    assert summary["platform"] == "cpu" and summary["card"] is None
    assert summary["bound_satisfied"] is True
    assert summary["unit"] == "GB/s" and summary["n"] == N_CPU
    assert summary["host_codec"] in ("zstd", "zlib")
    for k in ("value", "vs_baseline", "compress_gbps", "decompress_gbps", "ratio"):
        assert np.isfinite(summary[k]) and summary[k] > 0, k
    sections = [json.loads(ln)["section"] for ln in lines[:-1]]
    rec = json.loads(out.read_text())
    assert sections == list(rec["sections"])
    assert rec["last_line"] == summary and rec["platform"] == "cpu"
    sec = rec["sections"]
    assert sec["sync_us"] is None and rec["kind"] is None
    assert list(sec["peak_memory"]) == ["headline_compress", "headline_decompress",
                                        "big_compress"]
    assert all(v is None for v in sec["peak_memory"].values())
    assert sec["amortized"]["clock"] == "host perf_counter"
    assert sec["headline"]["ratio"] == summary["ratio"]
    assert 0.0 <= sec["overlap"]["compress_frac"] <= 1.0
    assert sec["overlap"]["segments"] == 4
    assert sec["big"]["segments"] == 16 and sec["big"]["n"] == 8 * N_CPU
    # the array compressed is the device formula, within sin ulps of the
    # host one
    assert 0.0 <= sec["headline"]["input_max_abs_diff_vs_host_formula"] < 1e-4
    assert sec["native"]["ratio"] > 1.0


@pytest.mark.parametrize("segment_elems", ["auto", 1 << 14])
def test_default_container_matches_reference(oracle, ref_arithmetic, segment_elems):
    """bench.CFG_DEFAULT on the bench array made on the device (the CPU
    here): the container (a DTZS stream frame by frame at a given segment
    size) equals dctz_tpu's of the same array under the oracle but for the
    header's mean, within MEAN_ULPS (a float32 sum in another order), and
    so has its ratio."""
    import dctz_tpu
    import jax.numpy as jnp

    import dctz_tpu_torch as dz
    from dctz_tpu_torch import bench
    from dctz_tpu_torch.utils.bench_data import climate_formula_torch

    cfg = dataclasses.replace(bench.CFG_DEFAULT, segment_elems=segment_elems)
    x = climate_formula_torch(N_CPU, "cpu")
    x_np = x.numpy()
    port = dz.compress(x, config=cfg, device="cpu")
    ref = dctz_tpu.compress(jnp.asarray(x_np), config=dctz_tpu.CodecConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    assert len(frames_of(port)) == (1 if segment_elems == "auto" else 4)
    assert_byte_equal(port, ref, x_np, edge_flips=True)
    assert len(port) == len(ref)


def test_interval_overlap_matches_bench_py():
    """The port's _interval_overlap is bench.py's on seeded synthetic
    traces (overlapping, serial, empty, one-sided)."""
    from dctz_tpu_torch import bench

    env: dict = {}
    exec(compile(ast.Module([_function(_bench_py(), "_interval_overlap")], []),
                 "bench.py", "exec"), env)
    ref = env["_interval_overlap"]
    rng = np.random.default_rng(18)
    traces = [[], [("pull", 0, 0.0, 1.0)], [("device", 0, 0.0, 1.0)]]
    for _ in range(40):
        tr, t = [], 0.0
        for s in range(int(rng.integers(1, 9))):
            for kind in rng.permutation(["device", "pull", "pack", "prep"]):
                a = t + float(rng.uniform(-0.5, 0.5))
                tr.append((str(kind), s, a, a + float(rng.uniform(0.0, 1.0))))
            t += float(rng.uniform(0.1, 1.0))
        traces.append(tr)
    for tr in traces:
        # the port reads utils.timing.Span records: name, index, start, end,
        # thread, parent
        spans = [(k, s, a, b, "MainThread", None) for k, s, a, b in tr]
        for kinds in (("pull", "pack"), ("prep",)):
            assert bench._interval_overlap(spans, kinds) == ref(tr, kinds)


def test_pipelined_model_matches_bench_py():
    """The port's pipelined_model and steady_state_s are bench.py's formulas
    (bench_jax's pipe_c, pipe_d and its headline, serial, ceiling and
    per-direction rates; measure_pipeline_1gb's pipe), unrounded, on seeded
    stage times and overlap fractions."""
    from dctz_tpu_torch import bench

    tree = _bench_py()
    jx, big = _function(tree, "bench_jax"), _function(tree, "measure_pipeline_1gb")
    rng = np.random.default_rng(7)
    for _ in range(50):
        dev_c, host_c, dev_d, host_d = (float(v) for v in rng.uniform(1e-4, 0.1, 4))
        f_c, f_d = (float(v) for v in rng.uniform(0.0, 1.0, 2))
        segments, gb = int(rng.integers(1, 17)), float(rng.uniform(0.01, 2.0))
        env = dict(dev_c=dev_c, host_c=host_c, dev_d=dev_d, host_d=host_d,
                   f_c=f_c, f_d=f_d, S=segments, gb=gb)
        env["pipe_c"] = _eval(_assigned(jx, "pipe_c"), env)
        env["pipe_d"] = _eval(_assigned(jx, "pipe_d"), env)
        env["total"] = _eval(_assigned(jx, "total"), env)
        got = bench.pipelined_model(dev_c, host_c, dev_d, host_d, f_c, f_d, segments, gb)
        assert got["pipe_compress_s"] == env["pipe_c"]
        assert got["pipe_decompress_s"] == env["pipe_d"]
        for port_key, ref_key in (("pipelined_model_gbps", "gbps"),
                                  ("serial_sum_gbps", "serial_sum_gbps"),
                                  ("device_bound_ceiling_gbps", "device_bound_ceiling_gbps"),
                                  ("compress_gbps", "compress_gbps"),
                                  ("decompress_gbps", "decompress_gbps")):
            assert got[port_key] == _eval(_returned(jx, ref_key), env), port_key
        dev_s, packs, f = dev_c * segments, host_c * segments, f_c
        want = _eval(_assigned(big, "pipe"), dict(dev_s=dev_s, packs=packs, f=f,
                                                   S=segments))
        assert bench.steady_state_s(dev_s, packs, f, segments) == want


def test_default_device_without_a_card_exits_nonzero(tmp_path):
    """No card visible (CUDA_VISIBLE_DEVICES empty, whatever the machine
    holds): the default device exits non-zero, prints no result and writes
    no record."""
    res, out = _run_bench(tmp_path, "--n", "4096", env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "--device cpu" in res.stderr
    assert not out.exists()
