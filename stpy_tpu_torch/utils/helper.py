"""Small numeric helpers: the port of stpy_tpu/utils/helper.py.

Grids are built on the host in numpy and returned as tensors on the card
(or `device`); the gradient helpers evaluate a caller's function on float64
or complex128 CPU tensors; the batched derivatives use `torch.func`.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def cartesian(arrays) -> np.ndarray:
    """Cartesian product of 1-D arrays, shape (prod(len_i), d), first array
    varying slowest (stpy_tpu/utils/helper.py:16-24)."""
    arrays = [np.asarray(a).ravel() for a in arrays]
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def interval(n: int, d: int, L_infinity_ball: float = 1.0, offset=None,
             device=None, dtype=torch.float32) -> torch.Tensor:
    """Tensor grid of n points per dimension over [-L, L]^d, shape
    (n**d, d), first coordinate varying slowest."""
    xs = [np.linspace(-L_infinity_ball, L_infinity_ball, n) for _ in range(d)]
    if offset is not None:
        xs = [x + o for x, o in zip(xs, np.asarray(offset).ravel())]
    return as_tensor(cartesian(xs), device=resolve_device(device), dtype=dtype)


def interval_grid(n: int, d: int, bounds, device=None,
                  dtype=torch.float32) -> torch.Tensor:
    """Tensor grid with per-dimension (low, high) bounds, shape (n**d, d)."""
    bounds = np.asarray(bounds, dtype=float).reshape(d, 2)
    xs = [np.linspace(bounds[i, 0], bounds[i, 1], n) for i in range(d)]
    return as_tensor(cartesian(xs), device=resolve_device(device), dtype=dtype)


def symsqrt(A) -> torch.Tensor:
    """Square root V·diag(√w)·Vᵀ of a symmetric PSD matrix, eigenvalues
    clipped at 0. The eigh runs in float64, as `linalg.symsqrt`'s."""
    w, V = torch.linalg.eigh(A.to(torch.float64))
    w = torch.clamp(w, min=0.0)
    return ((V * torch.sqrt(w)) @ V.T).to(A.dtype)


def logdet(L) -> torch.Tensor:
    """log|A| from a Cholesky factor L of A."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L)))


def finite_difference_gradient(f, x, eps=1e-6) -> np.ndarray:
    """Central finite differences of f at x; f is called on float64 CPU
    tensors and its value read as a float."""
    x = torch.as_tensor(np.asarray(x, dtype=float).ravel())
    g = np.zeros(x.numel())
    for i in range(x.numel()):
        e = torch.zeros_like(x)
        e[i] = eps
        g[i] = (float(f(x + e)) - float(f(x - e))) / (2 * eps)
    return g


def complex_step_gradient(f, x, eps=1e-20) -> np.ndarray:
    """Complex-step derivative Im f(x + iεeᵢ)/ε, exact to rounding for a
    holomorphic f; f is called on complex128 CPU tensors."""
    x = torch.as_tensor(np.asarray(x, dtype=float).ravel()).to(
        torch.complex128)
    g = np.zeros(x.numel())
    for i in range(x.numel()):
        e = torch.zeros_like(x)
        e[i] = 1j * eps
        g[i] = float(torch.imag(torch.as_tensor(f(x + e)))) / eps
    return g


def batch_jacobian(f, x):
    """Per-row Jacobians of f: (n, d_in) -> (n, d_out, d_in)."""
    return torch.func.vmap(torch.func.jacrev(f))(x)


def batch_hessian(f, x):
    """Per-row Hessians of a scalar f: (n, d) -> (n, d, d)."""
    return torch.func.vmap(torch.func.hessian(f))(x)
