"""Device milliseconds per call of the program's hand kernels (csrc/),
with their pre-passes and reductions (portbench/kernels/)."""


def read(run):
    if run.profile is None or not run.calls:
        return None
    s = sum(run.profile.kernels.values())
    return s * 1e3 / len(run.calls) if s > 0 else None
