"""The check after the window: each field's kept round trips judged by the
plain reference (reference/check.py), one after another (the reference's
BLAS products are not run from several threads at once)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import check, rans


def host_field(x) -> np.ndarray:
    """The field as the check reads it: float32 on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def judge(kept, host: dict, config: dict, seed: int) -> dict:
    """The worst reading of each number over the kept round trips."""
    frames = int(config["check"]["frames"])
    with rans.process_pool() as pool:
        return check.combine([
            check.check(host[k.field], k.blob, k.out, config,
                        seed + k.iteration, frames, pool)
            for k in kept
        ])
