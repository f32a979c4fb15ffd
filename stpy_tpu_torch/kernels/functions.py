"""Distance primitives and the SE / half-integer Matérn / Laplace shapes.

Port of the part of stpy_tpu/kernels/functions.py that the exact-GP slice
uses. The rest of the catalogue (gibbs, polynomial, step, wiener, spectral,
angsim, general-ν Matérn) is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import math

import torch


def sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, (n, m): one matmul plus rank-1
    norm corrections, clamped at 0 (stpy_tpu/kernels/functions.py:25-31)."""
    nx = torch.sum(x * x, dim=1)[:, None]
    ny = torch.sum(y * y, dim=1)[None, :]
    return torch.clamp(nx + ny - 2.0 * (x @ y.T), min=0.0)


def euclid_dist(x, y, eps=1e-36):
    return torch.sqrt(sq_dist(x, y) + eps)


def manhattan_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise L1 distances Σ_c |x_c − y_c|, (n, m)
    (stpy_tpu/kernels/functions.py:39-40)."""
    return torch.cdist(x, y, p=1)


def se_shape(sq: torch.Tensor) -> torch.Tensor:
    """Squared-exponential correlation of a squared scaled distance."""
    return torch.exp(-0.5 * sq)


def matern_shape(dists: torch.Tensor, nu: float) -> torch.Tensor:
    """Matérn correlation of a scaled distance, ν ∈ {½, 3/2, 5/2}."""
    if nu == 0.5:
        return torch.exp(-dists)
    if nu == 1.5:
        k = dists * math.sqrt(3.0)
        return (1.0 + k) * torch.exp(-k)
    if nu == 2.5:
        k = dists * math.sqrt(5.0)
        return (1.0 + k + k * k / 3.0) * torch.exp(-k)
    raise NotImplementedError(
        f"Matérn nu={nu}: general-ν Matérn is ROADMAP Queue 1 item 7"
    )


def laplace_shape(d1: torch.Tensor) -> torch.Tensor:
    """Laplace correlation exp(−d1) of a scaled L1 distance
    d1 = ‖x − y‖₁/γ² (stpy_tpu/kernels/functions.py:71-75)."""
    return torch.exp(-d1)
