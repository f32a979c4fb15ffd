"""Scalar root finding and minimisation (port of stpy_tpu/opt/scalar.py:
`bisection`, `golden_section`, `newton_1d`). The JAX `fori_loop` and
`while_loop` are Python loops with the same steps and stop tests."""

from __future__ import annotations

import math

import torch


def _scalar(v, like=None):
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else v.to(torch.float64)
    dtype = like.dtype if isinstance(like, torch.Tensor) and \
        like.is_floating_point() else torch.float64
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(v, dtype=dtype, device=device)


def bisection(g, a, b, iters: int = 100):
    """Root of g on [a, b] (g(a), g(b) of opposite signs): the midpoint
    after `iters` halvings. Elementwise over tensors a and b (the JAX
    package vmaps over their leading dims)."""
    a = _scalar(a, b)
    b = _scalar(b, a).to(a.dtype)
    for _ in range(iters):
        m = 0.5 * (a + b)
        left = g(a) * g(m) <= 0.0
        a, b = torch.where(left, a, m), torch.where(left, m, b)
    return 0.5 * (a + b)


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


def newton_1d(g, x0, iters: int = 50, tol: float = 1e-12):
    """Scalar Newton for g(x) = 0, the derivative by autograd; stops after
    `iters` steps or once a step is no larger than `tol`."""
    x = _scalar(x0).detach()
    step, it = math.inf, 0
    while it < iters and abs(step) > tol:
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            gx = g(xg)
            (dg,) = torch.autograd.grad(gx, xg)
        s = gx.detach() / dg
        x, step, it = x - s, float(s), it + 1
    return x
