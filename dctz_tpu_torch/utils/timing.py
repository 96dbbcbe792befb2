"""Per-stage wall-clock timing (port of dctz_tpu/utils/timing.py).

PyTorch launches CUDA work asynchronously, so a stage that ends with device
work is only measured right when the timer synchronizes: with sync=True every
stage boundary calls torch.cuda.synchronize() (when CUDA is initialized).
Leave it False on production paths to keep launches asynchronous.

    t = StageTimer(sync=True)
    with t.stage("device"):
        ...
    print(t.report(nbytes))

The API's stages: "transfer" (host-device copies), "device" (kernels),
"zlib" (compress: section coding and container assembly), "rate"
(compress with rate="auto": the trial encodes that pick brsf), "host"
(decompress: parse, inflate, re-pad) and "pipeline" (a segmented DTZS stream,
whose device and host stages overlap; stream.py traces them per segment).
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


class StageTimer:
    """Accumulates named stage durations; reentrant stages sum up."""

    def __init__(self, sync: bool = False) -> None:
        self.stages: dict[str, float] = {}
        #: rate="auto": (brsf, container bytes, seconds) of each trial
        #: encode, in ladder order (api._auto_rate_brsf)
        self.rate_trials: list[tuple[float, int, float]] = []
        self.sync = sync
        self._t0 = time.perf_counter()

    def _sync(self) -> None:
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self) -> "StageTimer":
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        self.total = time.perf_counter() - self._t0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self, nbytes: int | None = None) -> dict:
        """Structured breakdown: total and per-stage seconds, and MB/s."""
        total = getattr(self, "total", sum(self.stages.values()))
        out: dict = {"total_s": total, "stages_s": dict(self.stages)}
        if nbytes is not None and total > 0:
            out["mb_per_s"] = nbytes / 1e6 / total
        return out
