"""The DTZS writer's pipeline stage per compress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "pipeline")
