"""Fit the model to the call's training rows (`fit_gp`); no output."""

FITS = True
JUDGE = None


def run(model, x, y, xt, step):
    model.fit_gp(x, y)
    return []
