"""The host parse, inflate and re-pad stage (host) per decompress call of a
monolithic container, ms."""

from benchmark.harness import readers


def read(run):
    return readers.stage_ms(run, "decompress", "host")
