"""The least time of the decode's work (roofline/work.py) over the kernel
time of the decompress calls, %."""

from benchmark.harness import readers


def read(run):
    return readers.roofline_pct(run, "decompress")
