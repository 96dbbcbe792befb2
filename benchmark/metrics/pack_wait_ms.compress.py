"""The DTZS writer's wait on its host packer (span pipeline.wait: the
caller blocked on the worker's pack of the previous frame) per compress
call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "pipeline.wait")
