"""Proximal and projection operators, and first-order constrained solvers.

Port of stpy_tpu/opt/prox.py: the projections and proxes (`prox_box`,
`prox_l1`, `prox_group_l2`, `project_simplex`, `project_l2_ball`) and the
solvers (`projected_gradient`, `projected_fista`, `fista_prox_backtracking`,
`fista_backtracking`). PyTorch runs eagerly, so each `lax.while_loop` is a
Python loop that reads its stop test on the host, with the JAX package's
stop tests; gradients come from autograd. `fun` maps a tensor to a scalar
tensor; the iterates keep x0's dtype and device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


# -- projections / proxes -----------------------------------------------------

def prox_box(x, lo=-math.inf, hi=math.inf):
    """Projection onto an axis-aligned box: a clip."""
    return torch.clamp(x, lo, hi)


def prox_l1(x, thresh):
    """Soft threshold (the L1 prox)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - thresh, min=0.0)


def prox_group_l2(x, thresh, groups):
    """Group soft threshold: each index group shrunk as a block (the group
    lasso's prox)."""
    out = x.clone()
    for g in groups:
        idx = torch.as_tensor(g, device=x.device)
        v = x[idx]
        nrm = torch.linalg.vector_norm(v)
        scale = torch.clamp(1.0 - thresh / torch.clamp(nrm, min=1e-30),
                            min=0.0)
        out[idx] = v * scale
    return out


def project_simplex(x):
    """Euclidean projection onto the probability simplex (sort based,
    O(n log n))."""
    n = x.shape[0]
    u = torch.sort(x, descending=True).values
    css = torch.cumsum(u, dim=0)
    ks = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    cond = u + (1.0 - css) / ks > 0
    rho = int(torch.max(torch.where(cond, ks, torch.zeros_like(ks))))
    lam = (1.0 - css[rho - 1]) / rho
    return torch.clamp(x + lam, min=0.0)


def project_l2_ball(x, radius=1.0):
    nrm = torch.linalg.vector_norm(x)
    return torch.where(nrm > radius, x * (radius / nrm), x)


# -- solvers ------------------------------------------------------------------

class SolveResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    iterations: int
    converged: bool


def _grad(fun):
    def g(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(fun(xg), xg)
        return gx
    return g


def _value_and_grad(fun):
    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            f = fun(xg)
            (gx,) = torch.autograd.grad(f, xg)
        return f.detach(), gx
    return vg


def _value(fun, x):
    with torch.no_grad():
        return fun(x)


def _moved(x, xp) -> float:
    return float(torch.linalg.vector_norm(x - xp))


def projected_gradient(
    fun: Callable, x0: torch.Tensor, project: Callable,
    lr: float | None = None, max_iter: int = 500, tol: float = 1e-9,
    lipschitz: float | None = None,
) -> SolveResult:
    """Projected gradient descent with the fixed step 1/L (or `lr`)."""
    step = (1.0 / lipschitz) if lipschitz is not None else (lr or 1e-2)
    g = _grad(fun)
    xp = x0
    x = project(x0 - step * g(x0))
    it = 1
    while it < max_iter and _moved(x, xp) > tol:
        x, xp = project(x - step * g(x)), x
        it += 1
    return SolveResult(x, _value(fun, x), it, _moved(x, xp) <= tol)


def projected_fista(
    fun: Callable, x0: torch.Tensor, project: Callable,
    lipschitz: float, max_iter: int = 500, tol: float = 1e-9,
) -> SolveResult:
    """FISTA (accelerated proximal gradient) with a projection as its prox,
    step 1/L."""
    step = 1.0 / lipschitz
    g = _grad(fun)
    x = y = x0
    t = x0.new_tensor(1.0)
    xp, it = x0 + 1.0, 0
    while it < max_iter and _moved(x, xp) > tol:
        xn = project(y - step * g(y))
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = xn + ((t - 1.0) / tn) * (xn - x)
        x, xp, t, it = xn, x, tn, it + 1
    return SolveResult(x, _value(fun, x), it, _moved(x, xp) <= tol)


def _fista_bt(fun, x0, step_to, l0, eta, max_iter, tol):
    """FISTA with backtracking on the Lipschitz estimate L: `step_to(y, gy,
    L)` is the prox-gradient point from y. Each backtracking loop stops at
    the first L that passes the quadratic upper bound, or once L ≥ 1e18."""
    vg = _value_and_grad(fun)
    x = y = x0
    t = x0.new_tensor(1.0)
    L = x0.new_tensor(float(l0))
    xp, it = x0 + 1.0, 0
    while it < max_iter and _moved(x, xp) > tol:
        fy, gy = vg(y)
        xn = step_to(y, gy, L)
        ok = False
        while not ok and bool(L < 1e18):
            xn = step_to(y, gy, L)
            diff = xn - y
            q = fy + torch.dot(gy.reshape(-1), diff.reshape(-1)) \
                + 0.5 * L * torch.dot(diff.reshape(-1), diff.reshape(-1))
            ok = bool(_value(fun, xn) <= q + 1e-12)
            if not ok:
                L = L * eta
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = xn + ((t - 1.0) / tn) * (xn - x)
        x, xp, t, it = xn, x, tn, it + 1
    return SolveResult(x, _value(fun, x), it, _moved(x, xp) <= tol)


def fista_prox_backtracking(
    fun: Callable, x0: torch.Tensor, prox: Callable,
    l0: float = 1.0, eta: float = 2.0, max_iter: int = 500, tol: float = 1e-9,
) -> SolveResult:
    """FISTA for a composite objective fun + h with prox_h: `prox(x, step)`
    receives the current step 1/L (shrinkage proxes need it; projections
    can ignore it)."""
    return _fista_bt(fun, x0, lambda y, gy, L: prox(y - gy / L, 1.0 / L),
                     l0, eta, max_iter, tol)


def fista_backtracking(
    fun: Callable, x0: torch.Tensor, project: Callable,
    l0: float = 1.0, eta: float = 2.0, max_iter: int = 500, tol: float = 1e-9,
    max_bt: int = 30,
) -> SolveResult:
    """FISTA with backtracking on the Lipschitz estimate, no eigenvalue
    needed. `max_bt` is accepted for the JAX signature; as there, the
    backtracking stops on its test or at L ≥ 1e18."""
    return _fista_bt(fun, x0, lambda y, gy, L: project(y - gy / L),
                     l0, eta, max_iter, tol)
