"""Scalar minimisation (port of stpy_tpu/opt/scalar.py: `golden_section`,
the `optimizer="bisection"` branch of the hyperfit). The rest of the JAX
module (`bisection`, `newton_1d`) comes with the point-process stack
(ROADMAP Queue 1 item 9)."""

from __future__ import annotations

import math


def golden_section(f, a, b, iters: int = 80):
    """Minimise a unimodal scalar function on [a, b] by `iters` golden-
    section steps; returns the midpoint of the last bracket. `a` and `b`
    are tensors (their dtype is the iterates')."""
    gr = (math.sqrt(5.0) - 1.0) / 2.0
    for _ in range(iters):
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        if bool(f(c) < f(d)):
            b = d
        else:
            a = c
    return 0.5 * (a + b)
