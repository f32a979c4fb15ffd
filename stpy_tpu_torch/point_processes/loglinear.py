"""Log-linear rate model: log λ(x) = Φ(x)ᵀθ, fitted by least squares on the
log counts of the visited basic sets, with multiplicative (exp) per-set
bounds.

Port of stpy_tpu/point_processes/loglinear.py; the fit is L-BFGS
(opt/lbfgs.py) from θ = 0.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.point_processes.poisson_rate_estimator import (
    PoissonRateEstimator,
    jnp_pinv,
)


class LogLinearRateEstimator(PoissonRateEstimator):
    def least_squares_weighted(self, threads=0):
        """θ minimising Σ (φ_iᵀθ − log(max(o_i, 1e-6))/τ_i)² over the
        visited buckets (500 L-BFGS iterations from 0)."""
        mask = self.bucketized_counts > 0
        obs = torch.clamp(self.total_bucketized_obs[mask], min=1e-6)
        phis = self.varphis[mask]
        target = torch.log(obs) / self.total_bucketized_time[mask]

        def objective(theta):
            r = phis @ theta - target
            return torch.sum(r * r)

        res = minimize_lbfgs(objective, torch.zeros(
            self.get_m(), dtype=self.dtype, device=self.device), max_iter=500)
        self.rate = res.x
        return self.rate

    def fit_gp(self, threads=4):
        if self.data is None:
            self.rate = None
            return
        self.least_squares_weighted(threads)

    def construct_covariance_matrix_regression(self):
        """Count-record: Σ over visited buckets of τ_i φ_i φ_iᵀ/v_i; else
        Σ over rounds of ψψᵀ/max(ψᵀθ, 1e-8) with ψ = ∫_S Φ·dt; plus s·I."""
        W = self._zeros_mm()
        if self.data is not None and self.feedback == "count-record":
            Dw = self._visited_inverse_variances()
            W = (self.varphis * Dw[:, None]).T @ self.varphis
        elif self.data is not None:
            for S, _obs, dt in self.data:
                varphi = self.packing.integral(S) * dt
                variance = torch.clamp(varphi @ self.rate, min=1e-8)
                W = W + torch.outer(varphi, varphi) / variance
        return self._plus_s(W)

    def fit_ellipsoid_approx(self):
        self.W = self.construct_covariance_matrix_regression()
        self.W_inv = jnp_pinv(self.W)
        self.W_inv_approx = self.W_inv

    def mean_var_reg_set(self, S, dt=1.0, beta=2.0):
        """(map, ucb, lcb): sums over the basic sets inside S of
        exp(dt·(φᵀθ ± β·√(φᵀW⁻¹φ)))."""
        if not self.approx_fit:
            self.fit_ellipsoid_approx()
            self.approx_fit = True
        idx = self._contained_leaves(S)
        if not idx:
            return 0.0, 0.0, 0.0
        X = torch.stack([self.packing.integral(self.basic_sets[i])
                         for i in idx])
        width = beta * torch.sqrt(torch.einsum("ij,jk,ik->i", X, self.W_inv, X))
        mean = X @ self.rate
        return (torch.sum(torch.exp(dt * mean)),
                torch.sum(torch.exp(dt * (mean + width))),
                torch.sum(torch.exp(dt * (mean - width))))

    def mean_rate(self, S, n=128):
        return self.mean_rate_points(S.return_discretization(n))

    def mean_rate_points(self, xtest):
        return torch.exp(self.packing.embed(xtest) @ self.rate.reshape(-1, 1))

    def ucb(self, S, dt=1.0, delta=0.5):
        return float(self.mean_var_reg_set(S, dt=dt, beta=self.beta(0))[1])

    def lcb(self, S, dt=1.0):
        return float(self.mean_var_reg_set(S, dt=dt, beta=self.beta(0))[2])
