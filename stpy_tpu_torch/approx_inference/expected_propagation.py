"""Expectation propagation with Gaussian sites.

Port of stpy_tpu/approx_inference/expected_propagation.py: rank-one sites
(each datapoint constrains a linear functional a_iᵀθ), tilted moments by
Gauss-Hermite quadrature with numpy's nodes, as in the JAX package. The
model lives in `dtype` on `device` (the card unless the caller passes
another); `likelihood_single(z, datum)` maps a tensor of nodes to site
likelihoods.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def _gh(n=40, device=None, dtype=torch.float32):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (
        as_tensor(np.sqrt(2.0) * x, device=device, dtype=dtype),
        as_tensor(w / np.sqrt(np.pi), device=device, dtype=dtype),
    )


class ExpectedPropagationQuadratic:
    """EP for p(θ) ∝ N(θ; μ0, Σ0) Π_i t_i(a_iᵀθ) with scalar site
    likelihoods t_i (e.g. quadratic / Gaussian-of-square)."""

    def __init__(self, mu_prior, Sigma_prior, likelihood_single, data,
                 A=None, device=None, dtype=torch.float32):
        self.device, self.dtype = resolve_device(device), dtype
        self.mu0 = self._tensor(mu_prior).reshape(-1)
        self.Sigma0 = self._tensor(Sigma_prior)
        self.d = self.mu0.shape[0]
        self.likelihood_single = likelihood_single  # t(z, datum) -> R+
        self.data = data
        self.n = len(data)
        # site directions default to coordinate axes / provided rows
        self.A = (
            self._tensor(A) if A is not None
            else torch.eye(self.d, dtype=dtype, device=self.device)[
                torch.arange(self.n, device=self.device) % self.d
            ]
        )
        # site natural params (precision tau_i, shift nu_i) on z_i = a_iᵀθ
        self.tau = torch.zeros(self.n, dtype=dtype, device=self.device)
        self.nu = torch.zeros(self.n, dtype=dtype, device=self.device)
        self._gh_nodes = _gh(40, self.device, dtype)

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _posterior(self):
        """Global Gaussian from prior + sites: Σ = (Σ0^{-1} + Aᵀ diag(τ) A)^{-1}."""
        P0 = torch.linalg.inv(self.Sigma0)
        P = P0 + (self.A * self.tau[:, None]).T @ self.A
        Sigma = torch.linalg.inv(P)
        mu = Sigma @ (P0 @ self.mu0 + self.A.T @ self.nu)
        return mu, Sigma

    def _site_update(self, j, mu, Sigma, damping=0.8):
        a = self.A[j]
        m = a @ mu
        v = a @ Sigma @ a
        # cavity
        tau_c = torch.clamp(1.0 / v - self.tau[j], min=1e-8)
        nu_c = m / v - self.nu[j]
        mc, vc = nu_c / tau_c, 1.0 / tau_c
        # tilted moments by Gauss-Hermite
        xg, wg = self._gh_nodes
        z = mc + torch.sqrt(vc) * xg
        lik = torch.clamp(self.likelihood_single(z, self.data[j]), min=1e-300)
        Z = torch.sum(wg * lik)
        m1 = torch.sum(wg * lik * z) / Z
        m2 = torch.sum(wg * lik * z * z) / Z
        vt = torch.clamp(m2 - m1 * m1, min=1e-10)
        # new site params
        tau_new = torch.clamp(1.0 / vt - tau_c, min=1e-10)
        nu_new = m1 / vt - nu_c
        self.tau = self.tau.clone()
        self.nu = self.nu.clone()
        self.tau[j] = (1 - damping) * self.tau[j] + damping * tau_new
        self.nu[j] = (1 - damping) * self.nu[j] + damping * nu_new

    def fit_gp(self, iterations="auto", tol=1e-8):
        T = 50 if iterations == "auto" else iterations
        for _ in range(T):
            tau_old = self.tau
            mu, Sigma = self._posterior()
            for j in range(self.n):
                self._site_update(j, mu, Sigma)
                mu, Sigma = self._posterior()
            if float(torch.max(torch.abs(self.tau - tau_old))) < tol:
                break
        return self._posterior()

    def finalize(self):
        return self._posterior()
