"""Fit to the call's training rows and read the posterior mean and std at
its first `points` test points, in one `fit_predict`."""

from portbench.data import points

FITS = True
JUDGE = "posterior"


def run(model, x, y, xt, step):
    p = points(step, xt)
    mu, sd = model.fit_predict(x, y, xt[:p])
    return [("mean", p, mu), ("std", p, sd)]
