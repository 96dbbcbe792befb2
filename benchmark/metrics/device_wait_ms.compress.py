"""The program's own host-blocking waits on the device (span sync: scalar
reads, blocking copies, the pull's stream wait; on any thread) per
compress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "sync")
