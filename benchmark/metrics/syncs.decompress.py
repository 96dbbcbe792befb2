"""The program's host-blocking waits on the device (counter syncs: scalar
reads, blocking copies, stream waits) per decompress call."""

from benchmark.harness import readers


def read(run):
    return readers.count_per_call(run, "decompress", "syncs")
