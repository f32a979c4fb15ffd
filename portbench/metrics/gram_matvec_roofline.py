"""Share of its roofline that `gram_matvec` reached over the window: the least
time of the work the calls needed (portbench/roofline/gram_matvec.py) over the
device time of its kernels. None where either is unknown or nought."""

from portbench.roofline import gram_matvec as work


def read(run):
    if run.profile is None:
        return None
    spent = run.profile.kernels.get("gram_matvec", 0.0)
    least = work.least_ms(run)
    if not spent or not least:
        return None
    return 100.0 * least * 1e-3 / spent
