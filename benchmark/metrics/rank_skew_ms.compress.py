"""The slowest rank's seconds less the ranks' mean over the compress calls of
a cell of several ranks, ms: the time the collective call waits on its
slowest rank."""

from benchmark.harness import ranks


def read(run):
    return ranks.skew_ms(run, "compress")
