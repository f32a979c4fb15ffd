"""The fitted model's posterior mean at the call's first `points` test
points."""

from portbench.data import points

FITS = False
JUDGE = "posterior"


def run(model, x, y, xt, step):
    p = points(step, xt)
    return [("mean", p, model.mean(xt[:p]))]
