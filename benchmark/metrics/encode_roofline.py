"""The least time of the encode's work (roofline/work.py) over the kernel
time of the compress calls, %."""

from benchmark.harness import readers


def read(run):
    return readers.roofline_pct(run, "compress")
