"""Work of `qform_df`: the refined variance's one quadratic form per call,
q = Σ W0 ⊙ (2B − (Th + Tl)·W0 − s²W0) over the (n, n) train Gram and the
(n, t) test columns."""

from __future__ import annotations

from portbench.roofline.bounds import qform_bound


def products(run) -> int:
    return len(run.calls)


def least_ms(run) -> float:
    n, t = run.config["train_rows"], run.config["test_rows"]
    return qform_bound(n, n, t)[0] * len(run.calls)
