"""Trace-regression features: y ≈ Φ(x)ᵀ A Φ(x) with symmetric (optionally
PSD) matrix parameter A.

Port of stpy_tpu/models/trace_features.py: the fit is L-BFGS (the port's
`minimize_lbfgs`) on the symmetric parameterization (PSD via A = B Bᵀ),
and the confidence band is the closed-form quadratic form against V⁻¹.
The model lives on its embedding's device and dtype.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.linalg import cho_solve, safe_cholesky
from stpy_tpu_torch.models.feature_gp import KernelizedFeatures
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs


def _outer_rows(emb):
    """Row i = vec(φ_i φ_iᵀ), (n, m²)."""
    return torch.einsum("ij,ik->ijk", emb, emb).reshape(emb.shape[0], -1)


class TraceFeatures(KernelizedFeatures):
    def __init__(self, *args, PSD=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.m = int(self.m)
        self.PSD = PSD

    def construct_covariance(self):
        X = _outer_rows(self.emb)                                  # (n, m²)
        self.V = X.T @ X + self.lam * self.s**2 * self._eye(self.m**2)
        self._X_design = X

    def fit_gp(self, x, y):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.x, self.y = x, y
        self.n, self.d = x.shape
        self.emb = self.embed(x)
        self.construct_covariance()
        emb = self.emb
        yv = y.reshape(-1)
        m = self.m

        if self.PSD:
            def obj(flatB):
                B = flatB.reshape(m, m)
                A = B @ B.T
                pred = torch.einsum("ij,jk,ik->i", emb, A, emb)
                return torch.sum((pred - yv) ** 2) / self.s**2 + (
                    self.lam * torch.linalg.norm(A)
                )

            res = minimize_lbfgs(obj, 0.1 * self._eye(m).reshape(-1),
                                 max_iter=500)
            B = res.x.reshape(m, m)
            self.A = B @ B.T
        else:
            def obj(flatA):
                A = flatA.reshape(m, m)
                A = 0.5 * (A + A.T)
                pred = torch.einsum("ij,jk,ik->i", emb, A, emb)
                return torch.sum((pred - yv) ** 2) / self.s**2 + (
                    self.lam * torch.sqrt(torch.sum(A * A) + 1e-12)
                )

            res = minimize_lbfgs(
                obj, torch.zeros(m * m, dtype=self.dtype, device=self.device),
                max_iter=500)
            A = res.x.reshape(m, m)
            self.A = 0.5 * (A + A.T)
        self.fitted = True
        return self.A

    def mean_std(self, xtest, std=True):
        emb = self.embed(xtest)
        mu = torch.einsum("ij,jk,ik->i", emb, self.A, emb)[:, None]
        if not std:
            return mu
        X = _outer_rows(emb)
        Z = cho_solve(safe_cholesky(self.V).L, X.T)
        diag = self.lam * self.s**2 * torch.einsum("ij,ji->i", X, Z)
        return mu, torch.sqrt(torch.clamp(diag, min=0))[:, None]

    def band(self, xtest, sqrtbeta=2.0, maximization=True):
        """±sqrtβ ellipsoidal band on tr(A X_i) around the fit."""
        mu, std = self.mean_std(xtest)
        sgn = 1.0 if maximization else -1.0
        return mu + sgn * sqrtbeta * std
