"""Write the port's benchmark block in README.md from the committed record of
`python -m dctz_tpu_torch.bench` on the card (eval/bench_torch_h100.json):

    python -m dctz_tpu_torch.tools.sync_bench

The block lies between `<!-- bench-torch:begin -->` and
`<!-- bench-torch:end -->` in the README's port section; nothing outside the
markers changes, and no other file is written. A missing record, a null one
or one that is not a card's raises RecordError.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
RECORD = ROOT / "eval" / "bench_torch_h100.json"
README = ROOT / "README.md"
BEGIN, END = "<!-- bench-torch:begin -->", "<!-- bench-torch:end -->"


class RecordError(ValueError):
    """The benchmark record cannot be published."""


def load(path: pathlib.Path = RECORD) -> dict:
    """The record at `path`, checked to be one of the card."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise RecordError(f"no benchmark record at {path}: run `python -m "
                          "dctz_tpu_torch.bench --out <it>` on the card first")
    rec = json.loads(path.read_text())
    if not isinstance(rec, dict) or not isinstance(rec.get("last_line"), dict):
        raise RecordError(f"{path} holds no benchmark record (got {type(rec).__name__})")
    if rec.get("platform") != "gpu":
        raise RecordError(f"{path} is a record of platform {rec.get('platform')!r}, "
                          "not of the card")
    return rec


def block(rec: dict, src: str = "eval/bench_torch_h100.json") -> str:
    """The README block of a record."""
    last, sec = rec["last_line"], rec["sections"]
    head, mono, amo = sec["headline"], sec["monolithic"], sec["amortized"]
    big, base, peak = sec["big"], sec["native"], sec["peak_memory"]
    gib = 1 << 30
    lines = [
        BEGIN,
        f"Benchmark record `{src}` (`python -m dctz_tpu_torch.bench` on "
        f"{rec['card']}; regenerate this block with `python -m "
        "dctz_tpu_torch.tools.sync_bench`):",
        "",
        f"* **{last['value']:.3f} {last['unit']}**: {last['metric']}",
        f"* compress {head['compress_gbps']:.3f} GB/s / decompress "
        f"{head['decompress_gbps']:.3f} GB/s (medians of {head['reps']}); ratio "
        f"**{last['ratio']:.4f}**; bound satisfied on the full array: "
        f"**{last['bound_satisfied']}**; host codec {last['host_codec']}",
        f"* native C++ codec on the card's host: {base['gbps']:.4f} GB/s at "
        f"ratio {base['ratio']:.2f}: **{last['vs_baseline']:.1f}x**",
        f"* device stage, amortized over {amo['k']} calls: compress "
        f"{amo['compress']['per_call_s'] * 1e3:.3f} ms / decompress "
        f"{amo['decompress']['per_call_s'] * 1e3:.3f} ms per "
        f"{rec['n'] * 4 / 1e6:.0f} MB; sync latency {sec['sync_us']:.1f} us",
        f"* monolithic container (segment_elems=0): {mono['compress_gbps']:.3f} / "
        f"{mono['decompress_gbps']:.3f} GB/s; pipelined model "
        f"{sec['pipelined_model']['pipelined_model_gbps']:.3f} GB/s (a model, "
        "not a measurement)",
        f"* {big['n'] * 4 / 1e9:.2f} GB device-resident compress in "
        f"{big['segments']} frames: {big['wall_gbps']:.3f} GB/s wall; peak "
        f"device memory {peak['headline_compress']['peak_bytes'] / gib:.2f} / "
        f"{peak['headline_decompress']['peak_bytes'] / gib:.2f} / "
        f"{peak['big_compress']['peak_bytes'] / gib:.2f} GiB (compress, "
        "decompress, the big compress)",
        END,
    ]
    return "\n".join(lines)


def synced(text: str, blk: str) -> str:
    """text with its block replaced by blk."""
    if BEGIN not in text or END not in text:
        raise RecordError(f"README.md: missing the {BEGIN} / {END} markers")
    pat = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    return pat.sub(lambda _m: blk, text, count=1)


def main() -> int:
    README.write_text(synced(README.read_text(), block(load())))
    print(f"synced README.md from {RECORD.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
