"""Input bytes compressed in the window over the summed compress call
times, GB/s."""

from benchmark.harness import readers


def read(run):
    return readers.rate_gbps(run, "compress")
