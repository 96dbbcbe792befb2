"""The DTZS reader's pipeline stage per decompress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "pipeline")
