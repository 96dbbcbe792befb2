"""The host entropy and container stage (zlib) per compress call of a
monolithic container, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "zlib")
