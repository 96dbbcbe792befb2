"""The snapshot's input bytes over its containers' bytes, over the
window's calls (whole cycles through the fields), x."""


def read(run):
    calls = run.of("compress")
    return sum(c.nbytes for c in calls) / sum(c.blob_bytes for c in calls)
