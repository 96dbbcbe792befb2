"""Output bytes restored in a traced window over the summed decompress call
times, GB/s: the rate of decompress_gbps, read per layer in the cells whose
rate spreads too widely from run to run to hold an end-to-end bound."""

from benchmark.harness import readers


def read(run):
    return readers.rate_gbps(run, "decompress")
