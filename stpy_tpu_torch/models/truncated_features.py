"""Truncated-observation feature GP: responses beyond a growing threshold
α(t) are zeroed before the ridge solve (heavy-tail robustness). Port of
stpy_tpu/models/truncated_features.py."""

from __future__ import annotations

import torch

from stpy_tpu_torch.models.feature_gp import KernelizedFeatures


class TruncatedKernelizedFeatures(KernelizedFeatures):
    def __init__(self, embedding, m, s=0.001, lam=1, d=1, diameter=1,
                 verbose=True, groups=None, bounds=None, scale=1, kappa=1,
                 poly=2, primal=True, beta_fun=None,
                 alpha_score=lambda t: t ** (1 / 4),
                 default_alpha_score=1.0, bound=1.0):
        super().__init__(
            embedding, m, s=s, lam=lam, d=d, diameter=diameter,
            verbose=verbose, groups=groups, bounds=bounds, scale=scale,
            kappa=kappa, poly=poly, primal=True, beta_fun=beta_fun,
            bound=bound,
        )
        self.bound = bound
        self.alpha_score = alpha_score
        self.default_alpha_score = default_alpha_score
        self.alphas = None

    def fit_gp(self, x, y):
        y = self._tensor(y).reshape(-1, 1)
        self.alphas = torch.full_like(y, self.default_alpha_score)
        super().fit_gp(x, y)

    def add_data_point(self, x, y):
        x = self._tensor(x).reshape(-1, self.d)
        y = self._tensor(y).reshape(-1, 1)
        if self.x is not None:
            self.x = torch.cat([self.x, x])
            self.y = torch.cat([self.y, y])
            new_alpha = torch.full((1, 1), self.alpha_score(self.x.shape[0]),
                                   dtype=y.dtype, device=y.device)
            self.alphas = torch.cat([self.alphas, new_alpha])
        else:
            self.x, self.y = x, y
            self.alphas = torch.full_like(y, self.default_alpha_score)
        self.n = self.x.shape[0]
        self.fitted = False

    def precompute(self):
        if self.fitted:
            return
        self.Q = self.embed(self.x)
        self.V = self.Q.T @ self.Q
        self.V.diagonal().add_(self._ridge())
        self.invV = self._inverse(self.V)
        self.y_truncated = torch.where(torch.abs(self.y) < self.alphas,
                                       self.y, torch.zeros_like(self.y))
        self.dual = False
        self.fitted = True

    def theta_mean(self, var=False, prior=False):
        self.precompute()
        if self.fitted and not prior:
            tm = self.invV @ (self.Q.T @ self.y_truncated)
            Z = self.s**2 * self.invV
        else:
            tm = torch.zeros((self.m, 1), dtype=self.dtype, device=self.device)
            Z = self.lam * self._eye(self.m)
        return (tm, Z) if var else tm
