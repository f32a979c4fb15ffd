"""Misc custom optimizers: damped Newton root solver, greedy set selection,
Hermitian trace-regression recovery.

Port of stpy_tpu/opt/custom.py. `newton_solve`'s `lax.while_loop` is a
Python loop that reads its stop test on the host; the Jacobian comes from
`torch.autograd.functional.jacobian` where no `grad` is given. The
trace-regression recovery runs on the port's `minimize_lbfgs`.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs


def greedy_per_step(fun, add, ground_set, minimize=True):
    """Pick the ground-set element whose addition optimizes fun."""
    scores = [
        float(fun(add(ground_set[e : e + 1]))) for e in range(ground_set.shape[0])
    ]
    j = int(np.argmin(scores) if minimize else np.argmax(scores))
    return [j]


def newton_solve(f, x0, eps=1e-6, maxiter=100, verbose=False, grad=None,
                 device=None):
    """Damped (Levenberg-style) Newton for the root of a vector field f:
    the damping halves after a step that lowers max f² and doubles after
    one that does not. `device` places an x0 that is not a tensor yet."""
    if not isinstance(x0, torch.Tensor):
        x0 = as_tensor(x0, device=resolve_device(device), dtype=torch.float64)
    elif not x0.is_floating_point():
        x0 = x0.to(torch.get_default_dtype())
    if grad is None:
        def jac(x):
            return torch.autograd.functional.jacobian(f, x)
    else:
        jac = grad
    d = x0.shape[0]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)

    def resid(x):
        return torch.max(f(x) ** 2)

    x, s, r, it = x0.detach(), 1.0, resid(x0.detach()), 0
    while bool(r > eps) and it < maxiter:
        J = jac(x)
        xn = x - torch.linalg.solve(J + eye * s, f(x).reshape(-1, 1)).reshape(-1)
        rn = resid(xn)
        if bool(rn < r):
            x, r, s = xn, rn, s / 2.0
        else:
            s = s * 2.0
        it += 1
        if verbose:
            print(it, float(r))
    return x


def matrix_recovery_hermitian_trace_regression(X_list, b, eps=1e-5,
                                               lam_nuc=1.0, max_iter=500,
                                               device=None,
                                               dtype=torch.float64):
    """Recover PSD Z with tr(X_i Z) ≈ b_i and least trace (nuclear norm):
    Z = Y Yᵀ, L-BFGS on tr(Y Yᵀ) plus a penalty on the violations."""
    dev = resolve_device(device)
    X = torch.stack([as_tensor(Xi, device=dev, dtype=dtype) for Xi in X_list])
    b = as_tensor(b, device=dev, dtype=dtype).reshape(-1)
    d = X.shape[1]

    def obj(yflat):
        Y = yflat.reshape(d, d)
        Z = Y @ Y.T
        tr = torch.einsum("nij,ji->n", X, Z)
        viol = torch.clamp(torch.abs(tr - b) - eps, min=0.0)
        return lam_nuc * torch.trace(Z) + 1e4 * torch.sum(viol**2)

    y0 = 0.1 * torch.eye(d, dtype=dtype, device=dev).reshape(-1)
    res = minimize_lbfgs(obj, y0, max_iter=max_iter)
    Y = res.x.reshape(d, d)
    return Y @ Y.T
