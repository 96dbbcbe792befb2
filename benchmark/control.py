"""Readings of the correctness check for setting its limits: the program's
(sound runs) and the control's (reference/control.py: the reference codec
in bfloat16 in the program's place), on the same fields and frames, for
each of several seeds, at the cell's own size. The benchmark's runs never
run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--device cpu]

For each seed, every field goes through the public compress / decompress
once and is judged as a run judges it; the control then reads the same
fields. With
--high the program is also read with dct_precision="high" (its own relaxed
bf16x3 analysis transform). One JSON line a seed.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--high", action="store_true")
    args = p.parse_args(argv)
    import torch

    import dctz_tpu_torch as dz
    from benchmark.harness import spec
    from benchmark.reference import rans

    cell = spec.load_cell(args.workload)
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    config, codec, shape = cell.config, dict(cell.config["codec"]), None
    if device.type == "cpu":
        reh = config["rehearsal"]
        shape = reh["shape"]
        if "segment_elems" in reh:
            codec["segment_elems"] = reh["segment_elems"]
            config = dict(config, container=dict(
                config["container"], segment_elems=reh["segment_elems"]))
    cfgs = {"program": dz.CodecConfig(**codec)}
    if args.high:
        cfgs["program_high"] = dz.CodecConfig(**dict(codec, dct_precision="high"))
    frames = int(config["check"]["frames"])
    with rans.process_pool() as pool:
        for seed in (int(s) for s in args.seeds.split(",")):
            _seed(seed, cell, config, cfgs, frames, device, shape, pool)
    return 0


def _seed(seed, cell, config, cfgs, frames, device, shape, pool):
    """One JSON line: the program's and the control's readings on one
    seed's fields."""
    import torch

    import dctz_tpu_torch as dz
    from benchmark.harness import correct, window
    from benchmark.reference import check, control

    t0 = time.perf_counter()
    fields = window.make_fields(cell, seed, device, shape)
    picks = range(len(fields))
    line = {"seed": seed}
    for name, cfg in cfgs.items():
        rs = []
        for i, f in enumerate(picks):
            blob = dz.compress(fields[f], config=cfg, device=device)
            out = dz.decompress(blob, device=device)
            rs.append(check.check(correct.host_field(fields[f]), blob, out,
                                  config, seed + i, frames, pool))
        line[name] = check.combine(rs)
    line["control"] = check.combine([
        control.readings(correct.host_field(fields[f]), config, seed + i,
                         frames, device) for i, f in enumerate(picks)])
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    del fields
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
