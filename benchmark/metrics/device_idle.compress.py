"""The share of the compress calls' time in which no kernel, copy or memset
ran on the device."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run, "compress")
