"""Sliced inverse regression (SIR) dimension reduction: the port of
stpy_tpu/dimred.py.

`SRI` standardises X, slices the rows by the response and takes the
eigenvectors of the slice means' weighted covariance. Its tensors live on
the card (or `device`) in `dtype`; the eigendecompositions run in float64,
as the port's `linalg.symsqrt` does, and the results are returned in
`dtype`. An eigenvector's sign is the eigensolver's choice.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.linalg import symsqrt


def _eigh_descending(M):
    """(eigenvalues, eigenvectors) of symmetric M, largest first, by a
    float64 eigh, returned in M's dtype."""
    w, V = torch.linalg.eigh(M.to(torch.float64))
    return (torch.flip(w, dims=[0]).to(M.dtype),
            torch.flip(V, dims=[1]).to(M.dtype))


class SRI:
    def __init__(self, device=None, dtype=torch.float32):
        self.directions = None
        self.eigvals = None
        self.device, self.dtype = resolve_device(device), dtype

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def standardize(self, X):
        X = self._tensor(X)
        self.mean_ = torch.mean(X, dim=0)
        Xc = X - self.mean_
        cov = Xc.T @ Xc / X.shape[0]
        eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
        self.W_ = symsqrt(cov + 1e-8 * eye, inv=True)
        return Xc @ self.W_

    def fit_sri(self, X, y, buckets=10):
        """The effective-dimension-reduction directions (columns, largest
        eigenvalue first, in X's coordinates) and their eigenvalues."""
        Z = self.standardize(X)
        y = (y.cpu().numpy() if isinstance(y, torch.Tensor)
             else np.asarray(y)).ravel()
        order = np.argsort(y)
        slices = np.array_split(order, buckets)
        means = torch.stack(
            [torch.mean(Z[torch.as_tensor(s, device=Z.device)], dim=0)
             for s in slices], dim=0)
        weights = torch.tensor([len(s) / len(y) for s in slices],
                               dtype=Z.dtype, device=Z.device)
        M = (means * weights[:, None]).T @ means
        self.eigvals, V = _eigh_descending(M)
        self.directions = self.W_ @ V
        return self.directions, self.eigvals

    fit = fit_sri

    def transform(self, X, k=1):
        X = self._tensor(X) - self.mean_
        return X @ self.directions[:, :k]

    def gradient_design(self, d, k, nablaF, eps=1e-4):
        """The k leading directions of the gradients' outer-product mean,
        and their eigenvalues."""
        G = self._tensor(nablaF)
        w, V = _eigh_descending(G.T @ G / G.shape[0])
        return V[:, :k], w[:k]
