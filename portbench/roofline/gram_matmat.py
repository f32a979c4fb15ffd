"""Work of `gram_matmat`: the block products K(x, x)·V of a call.

Two solves need them: the preconditioner's Rayleigh compression, one
product with each 128-column slab of its rank-r landmark basis, and each
iteration of the block CG of the exact variance, one product with the
block's columns; one `gram_matmat` pass per kernel atom each. The
preconditioner's rank is the status's ``precond_rank``
(portbench/systems/iterative_gp.py); each block solve's (iterations,
columns) is recorded under ``block_cg`` by the `mean_std` op's instrument
(portbench/ops/mean_std.py). A call that ran `mean_std` on the CG tier and
recorded no block solve cannot be counted: the work is then unknown, not
zero, and `least_ms` gives None."""

from __future__ import annotations

import sys

from portbench.roofline.bounds import matmat_tc_bound

SLAB = 128    # columns of one preconditioner product


def _widths(status) -> list[int] | None:
    """The column count of every block product the call needed; None
    where its block solves went unrecorded."""
    rank = int(status.get("precond_rank", 0))
    if rank and "mean_std" in status.get("ops", ()) \
            and not status.get("block_cg"):
        return None
    widths = [min(SLAB, rank - c) for c in range(0, rank, SLAB)]
    for iters, cols in status.get("block_cg", ()):
        widths += [int(cols)] * int(iters)
    return widths


def _all_widths(run) -> list[list[int]] | None:
    widths = [_widths(c.status) for c in run.calls]
    if any(w is None for w in widths):
        print("gram_matmat roofline: a call ran mean_std on the CG tier and "
              "recorded no block CG solve (ops/mean_std.py instrument); "
              "its work is unknown, the metric is left out", file=sys.stderr)
        return None
    return widths


def products(run) -> int | None:
    widths = _all_widths(run)
    if widths is None:
        return None
    return len(run.config["kernel"]) * sum(len(w) for w in widths)


def least_ms(run) -> float | None:
    widths = _all_widths(run)
    if widths is None:
        return None
    n, d = run.config["train_rows"], run.config["d"]
    costs = [run.families[a["family"]].cost(a) for a in run.config["kernel"]]
    total = 0.0
    for w in widths:
        for r in w:
            total += sum(matmat_tc_bound(n, n, d, None, r, cost=c)[0]
                         for c in costs)
    return total
