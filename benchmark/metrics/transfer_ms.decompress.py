"""The API's transfer stage (the streams' upload and the result's pull) per
decompress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "transfer")
