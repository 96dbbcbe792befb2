"""The DTZS reader's wait on its host prep (span pipeline.wait: the caller
blocked on the worker's parse, inflate and re-pad of the frame) per
decompress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "pipeline.wait")
