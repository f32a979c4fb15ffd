"""Riemannian optimisation on the Stiefel and PSD manifolds.

Port of stpy_tpu/opt/manifold.py. Stiefel: the Euclidean gradient projected
onto the tangent space, then a QR retraction, `steps` times from a random
orthonormal start. PSD of fixed rank: L-BFGS (opt/lbfgs.py) on the factor
Y of A = Y Yᵀ. The JAX package runs its restarts as one `vmap`; here they
run one after another, each from its own draw of `generator` (`_normal`),
in float64. The best restart is the least finite value, as `nanargmin`.
Both run on the card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import resolve_device
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs


def _normal(generator, shape, device):
    """Standard normals of `shape` in float64 from `generator`, on
    `device`."""
    where = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=torch.float64,
                       device=where).to(device)


def _qr_retract(X):
    Q, R = torch.linalg.qr(X)
    s = torch.sign(torch.diagonal(R))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return Q * s[None, :]


def stiefel_project_tangent(X, G):
    """Project the Euclidean gradient G at X onto the Stiefel tangent
    space."""
    XtG = X.T @ G
    return G - X @ (0.5 * (XtG + XtG.T))


def _grad(fun, X):
    X = X.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fun(X), X)
    return g


def _best(values):
    v = torch.stack([torch.as_tensor(x, dtype=torch.float64).reshape(())
                     .cpu() for x in values])
    return int(torch.where(torch.isnan(v), torch.full_like(v, float("inf")),
                           v).argmin())


def optimize_stiefel(fun, n, p, steps=300, lr=0.1, restarts=4, generator=None,
                     device=None):
    """Minimise fun(X) over {X ∈ R^{n×p}: XᵀX = I} by projected gradient
    steps of size `lr` and QR retraction; the best of `restarts` random
    orthonormal starts. Returns (X, fun(X))."""
    device = resolve_device(device)
    Xs, vals = [], []
    for _ in range(restarts):
        X = _qr_retract(_normal(generator, (n, p), device))
        for _ in range(steps):
            X = _qr_retract(X - lr * stiefel_project_tangent(X, _grad(fun, X)))
        with torch.no_grad():
            vals.append(fun(X))
        Xs.append(X)
    best = _best(vals)
    return Xs[best], vals[best]


def optimize_psd(fun, d, rank=None, steps=300, restarts=4, generator=None,
                 max_iter=200, device=None):
    """Minimise fun(A) over PSD matrices A of rank r (default d) through
    A = Y Yᵀ, by L-BFGS on Y from 0.3·N(0, 1) starts; the best of
    `restarts`. Returns (A, value)."""
    device = resolve_device(device)
    r = rank or d

    def wrapped(yflat):
        Y = yflat.reshape(d, r)
        return fun(Y @ Y.T)

    results = [minimize_lbfgs(wrapped, 0.3 * _normal(generator, (d * r,),
                                                     device),
                              max_iter=max_iter)
               for _ in range(restarts)]
    best = _best([res.value for res in results])
    Y = results[best].x.reshape(d, r)
    return Y @ Y.T, results[best].value
