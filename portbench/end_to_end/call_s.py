"""The window's seconds over the calls completed in it: all the work over
all the time."""


def read(run):
    return run.window_s / len(run.calls)
