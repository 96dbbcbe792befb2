"""The API's transfer stage (the input's upload; on the monolithic path
also the streams' pull) per compress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "transfer")
