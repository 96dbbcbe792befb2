"""The host entropy and container layer's CPU time (stage key
cpu.entropy: thread CPU seconds of the parse, inflate and re-pad spans and
of the pool tasks they start, on every thread) per decompress call, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "cpu.entropy")
