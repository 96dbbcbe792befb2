"""The copy of each decoded DTZS frame into the host output (span
copy_out: the frame's kernels finishing, then the device-to-host copy)
per decompress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "copy_out")
