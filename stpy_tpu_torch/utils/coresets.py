"""Coresets: the port of stpy_tpu/utils/coresets.py.

ε-nets are the set's tensor grid; the greedy leverage-score coreset picks,
one point at a time, the grid point of largest GP posterior variance given
the points picked so far, through the port's `safe_cholesky` on the
kernel's Gram (the kernel's hand Gram on the card).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.linalg import safe_cholesky


def epsilon_net(borel_set, k):
    """Uniform tensor grid with k points per dimension over the set."""
    return borel_set.return_discretization(k)


def coreset(borel_set, k):
    return epsilon_net(borel_set, k)


def coreset_leverage_score_greedy(borel_set, kernel, n, tol=1e-3,
                                  grid=64, s=1e-3):
    """Greedily pick up to n grid points of largest posterior variance
    (noise variance s), stopping once the largest is below `tol`."""
    X = borel_set.return_discretization(grid)
    kd = kernel.diag(X)
    chosen = []
    for _ in range(n):
        if not chosen:
            var = kd
        else:
            xs = X[torch.as_tensor(chosen, device=X.device)]
            K = kernel.gram(xs) + s * torch.eye(len(chosen), dtype=X.dtype,
                                                device=X.device)
            L = safe_cholesky(K).L
            V = torch.linalg.solve_triangular(L, kernel.cross(X, xs).T,
                                              upper=False)
            var = kd - torch.sum(V * V, dim=0)
        j = int(torch.argmax(var))
        if float(var[j]) < tol:
            break
        chosen.append(j)
    return X[torch.as_tensor(chosen, dtype=torch.long, device=X.device)]
