"""Process start to the window's start: imports, the CUDA context, the
kernel library's load (its build on a checkout's first run), the fields
made from the seed, one warm round trip, s."""


def read(run):
    return run.setup_s
