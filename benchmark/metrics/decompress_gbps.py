"""Output bytes decompressed in the window over the summed decompress call
times, GB/s."""

from benchmark.harness import readers


def read(run):
    return readers.rate_gbps(run, "decompress")
