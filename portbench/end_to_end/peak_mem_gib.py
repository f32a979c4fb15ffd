"""The device's allocated peak over the window (reset at its start), GiB."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
