"""Device-to-host copies per call (each `.item()`, `bool()` or `.cpu()` of
a device tensor is one): each waits for the device and leaves it idle until
the host launches again. Counted from the device's own copy events, so a
trace of the device alone reads them."""


def read(run):
    if run.profile is None or not run.calls:
        return None
    return run.profile.dtoh / len(run.calls)
