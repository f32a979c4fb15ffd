"""The fitted model's posterior mean and std at the call's first `points`
test points (`mean_std`: on the CG tier, the exact variance by one block
CG over the points' columns)."""

import contextlib

from portbench.data import points

FITS = False
JUDGE = "posterior"


def run(model, x, y, xt, step):
    p = points(step, xt)
    mu, sd = model.mean_std(xt[:p])
    return [("mean", p, mu), ("std", p, sd)]


@contextlib.contextmanager
def instrument(record):
    """In traced runs: each block CG solve's (iterations, columns) under
    the call's status["block_cg"], which the program does not keep. It
    wraps `parallel.iterative.cg_solve_block` as `mean_std` looks it up;
    the gram_matmat roofline refuses to read a call that ran `mean_std` on
    the CG tier and recorded no solve here."""
    from stpy_tpu_torch.parallel import iterative

    solve = iterative.cg_solve_block

    def counted(matmat, B, *args, **kwargs):
        X, it = solve(matmat, B, *args, **kwargs)
        record("block_cg", (int(it), int(B.shape[1])))
        return X, it

    iterative.cg_solve_block = counted
    try:
        yield
    finally:
        iterative.cg_solve_block = solve
