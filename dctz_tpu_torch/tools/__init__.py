"""The port's tools (dctz_tpu.tools' counterparts); sync_bench writes the
README block of the port's benchmark record."""

from __future__ import annotations

import sys


def pop_device(argv: list[str], prog: str) -> str | None:
    """Take `--device cuda|cpu` out of argv and return the device ("cuda"
    when the option is absent), or None after a message on stderr when its
    value is missing or unknown."""
    if "--device" not in argv:
        return "cuda"
    i = argv.index("--device")
    if i + 1 >= len(argv) or argv[i + 1] not in ("cuda", "cpu"):
        print(f"{prog}: --device takes cuda or cpu", file=sys.stderr)
        return None
    device = argv[i + 1]
    del argv[i : i + 2]
    return device
