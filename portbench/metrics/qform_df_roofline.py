"""Share of its roofline that `qform_df` reached over the window: the least
time of the work the calls needed (portbench/roofline/qform_df.py) over the
device time of its kernels. None where either is unknown or nought."""

from portbench.roofline import qform_df as work


def read(run):
    if run.profile is None:
        return None
    spent = run.profile.kernels.get("qform_df", 0.0)
    least = work.least_ms(run)
    if not spent or not least:
        return None
    return 100.0 * least * 1e-3 / spent
