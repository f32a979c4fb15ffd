"""Seconds from the process's start to the first timed call: imports, the
kernel library, the pool, the model and the warm call."""


def read(run):
    return run.setup_s
