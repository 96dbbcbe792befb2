"""The host entropy and container layer's CPU time (stage key
cpu.entropy: thread CPU seconds of its spans and of the pool tasks they
start, on every thread) per compress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "compress", "cpu.entropy")
