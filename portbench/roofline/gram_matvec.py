"""Work of `gram_matvec`: the products K(x, x)·v of the CG fit.

Each CG iteration of the fit is one product (K + s²I)·v, one
`gram_matvec` pass per kernel atom, so a call needs atoms × its
`fit_status["cg_iterations"]` products at (n, n, d)."""

from __future__ import annotations

from portbench.roofline.bounds import matvec_bound


def _iterations(run) -> int:
    return sum(int(c.status.get("cg_iterations", 0)) for c in run.calls)


def products(run) -> int:
    """Atom products K_a(x, x)·v over the window's calls."""
    return len(run.config["kernel"]) * _iterations(run)


def least_ms(run) -> float:
    n, d = run.config["train_rows"], run.config["d"]
    per_iter = sum(matvec_bound(n, n, d, None,
                                cost=run.families[a["family"]].cost(a))[0]
                   for a in run.config["kernel"])
    return per_iter * _iterations(run)
