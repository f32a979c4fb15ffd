"""Share of the traced window in which no operation ran on the device."""


def read(run):
    if run.profile is None or run.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
