"""Iterations of the CG fit per call: `fit_status["cg_iterations"]`,
the mean over the window's calls."""


def read(run):
    its = [c.status["cg_iterations"] for c in run.calls
           if "cg_iterations" in c.status]
    return sum(its) / len(its) if its else None
