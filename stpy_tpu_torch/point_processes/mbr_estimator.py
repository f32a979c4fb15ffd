"""MBR positive estimator: the matrix-parameterised rate
λ(x) = Φ(x)ᵀΘΦ(x) with symmetric (or PSD, Θ = MMᵀ) Θ.

Port of stpy_tpu/point_processes/mbr_estimator.py: L-BFGS over the
symmetric or PSD-factor parameterisation from 0.1·I, the covariance over
vec(Θ) and the closed-form bands tr(ΘΨ) ± β·√(vec(Ψ)ᵀW⁻¹vec(Ψ)).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.point_processes.link_estimators import (
    PermanentalProcessRateEstimator,
)
from stpy_tpu_torch.point_processes.poisson_rate_estimator import jnp_pinv


def _quad_rows(E, Theta):
    """e_iᵀ Θ e_i for every row of E."""
    return torch.einsum("ij,jk,ik->i", E, Theta, E)


class MBRPositiveEstimator(PermanentalProcessRateEstimator):
    def __init__(self, *args, psd=False, **kwargs):
        super().__init__(*args, **kwargs)
        self.psd = psd
        if self.feedback == "count-record":
            nb = self.varLambdas.shape[0]
            self.varLambdas_vec = self.varLambdas.reshape(nb, -1)
        self.approx_solver = True

    # -- fits ----------------------------------------------------------------------
    def _theta_param(self, flat):
        m = self.get_m()
        M = flat.reshape(m, m)
        if self.psd:
            return M @ M.T
        return 0.5 * (M + M.T)

    def _flat0(self):
        return (0.1 * torch.eye(self.get_m(), dtype=self.dtype,
                                device=self.device)).reshape(-1)

    def penalized_likelihood(self, threads=4):
        """Θ minimising −Σ c log(oᵀΘo) + tr(ΣΨ dt·Θ) + s‖Θ‖²_F (800
        L-BFGS iterations)."""
        sumLambda, obs = self.sumLambda, self.observations
        mult = self.obs_multiplicities

        def loss(flat):
            Theta = self._theta_param(flat)
            val = torch.trace(sumLambda @ Theta)
            if obs is not None:
                q = _quad_rows(obs, Theta)
                val = -torch.sum(mult * torch.log(torch.clamp(q, min=1e-12))) + val
            return val + self.s * torch.sum(Theta ** 2)

        res = minimize_lbfgs(loss, self._flat0(), max_iter=800)
        self.rate = self._theta_param(res.x)
        return self.rate

    penalized_likelihood_fast = penalized_likelihood

    def penalized_likelihood_bins(self, threads=4):
        """The binned objective over the visited buckets:
        −Σ o log(τ·vec(Ψ_i)ᵀvec(Θ)) + Σ τ·vec(Ψ_i)ᵀvec(Θ) + s‖Θ‖²_F."""
        mask = self.bucketized_counts > 0
        obs = self.total_bucketized_obs[mask]
        tau = self.total_bucketized_time[mask]
        vlv = self.varLambdas_vec[mask]

        def loss(flat):
            Theta = self._theta_param(flat)
            lin = tau * (vlv @ Theta.reshape(-1))
            return (-torch.sum(obs * torch.log(torch.clamp(lin, min=1e-12)))
                    + torch.sum(lin) + self.s * torch.sum(Theta ** 2))

        res = minimize_lbfgs(loss, self._flat0(), max_iter=800)
        self.rate = self._theta_param(res.x)
        return self.rate

    def fit_gp(self, threads=4):
        if self.data is None:
            self.rate = None
            return
        if self.estimator == "bins":
            self.penalized_likelihood_bins(threads)
        else:
            self.penalized_likelihood(threads)

    # -- evaluation ------------------------------------------------------------------
    def mean_rate(self, S, n=128):
        return self.mean_rate_points(S.return_discretization(n))

    def mean_rate_points(self, xtest):
        return _quad_rows(self.packing.embed(xtest), self.rate)[:, None]

    def rate_value(self, x, dt=1):
        return _quad_rows(self.packing.embed(x) * dt, self.rate)[:, None]

    def mean_set(self, S, dt=1.0):
        if self.data is None:
            return self.b * S.volume()
        return torch.trace((self.product_integral(S) * dt) @ self.rate)

    # -- the covariance over vec(Θ) --------------------------------------------------
    def construct_covariance_matrix(self):
        return self.construct_covariance_matrix_regression()

    def construct_covariance_matrix_regression(self):
        """W = Σ over visited buckets of τ_i vec(Ψ_i)vec(Ψ_i)ᵀ/v_i + s·I on
        vec(Θ) (m² × m²), and its pseudo-inverse."""
        m2 = self.get_m() ** 2
        W = torch.zeros((m2, m2), dtype=self.dtype, device=self.device)
        if self.data is not None and self.feedback == "count-record":
            Dw = self._visited_inverse_variances()
            V = self.varLambdas_vec
            W = (V * Dw[:, None]).T @ V
        self.W = self._plus_s(W)
        self.W_inv_approx = jnp_pinv(self.W)
        return self.W

    def band_no_opt(self, S, beta=2.0, dt=1.0, maximization=True):
        """tr(ΘΨ) ± β·√(vec(Ψ)ᵀW⁻¹vec(Ψ)), Ψ = Ψ(S)·dt."""
        emb = self.product_integral(S) * dt
        v = emb.reshape(-1)
        mid = torch.trace(emb @ self.rate)
        width = beta * torch.sqrt(torch.clamp(v @ self.W_inv_approx @ v,
                                              min=0.0))
        return mid + width if maximization else mid - width

    band = band_no_opt

    def mean_var_reg_set(self, S, dt=1.0, beta=2.0, lcb_compute=False):
        if self.data is None:
            return (S.volume() * self.b, S.volume() * self.B,
                    S.volume() * self.b)
        if not self.approx_fit:
            self.construct_covariance_matrix()
            self.approx_fit = True
        ucb = self.band_no_opt(S, beta=beta, dt=dt, maximization=True)
        lcb = (self.band_no_opt(S, beta=beta, dt=dt, maximization=False)
               if lcb_compute else None)
        return None, ucb, lcb

    def mean_var_bins_set(self, S, dt=1.0, beta=2.0, lcb_compute=False):
        return self.mean_var_reg_set(S, dt=dt, beta=beta,
                                     lcb_compute=lcb_compute)

    def ucb(self, S, dt=1.0, delta=0.5):
        return float(self.mean_var_reg_set(S, dt=dt, beta=self.beta(0))[1])

    def lcb(self, S, dt=1.0):
        return float(self.mean_var_reg_set(S, dt=dt, beta=self.beta(0),
                                           lcb_compute=True)[2])
