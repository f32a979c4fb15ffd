"""Variational inference for the sigmoidal Gaussian Cox process (SGCP):
λ(x) = λ* · σ(g(x)),  g ~ GP.

Port of stpy_tpu/approx_inference/sgcp.py: the sparse-variational ELBO

  ELBO = Σ_n E_q[log(λ* σ(g(x_n)))] - λ* ∫_S E_q[σ(g(x))] dx - KL(q(u)‖p(u))

with q(u) = N(m, L Lᵀ) over whitened inducing values, the domain integral
on a fixed Gauss-Legendre grid and the expectations by Gauss-Hermite over
the marginal g(x) ~ N(μ(x), s²(x)).

`run` is Adam written out with optax's update (b1 = 0.9, b2 = 0.999,
eps = 1e-8, eps_root = 0; the step −lr·m̂/(√v̂ + eps)) as a loop of
autograd steps, where the JAX package scans `optax.adam` under one jit.
The whitened cross-covariances A = Lz⁻¹Kzx of the observations and the
quadrature nodes are constants of the fit and are solved once, at
construction, where the JAX package solves them inside every ELBO. The
inducing Gram, its factor and every A are formed in float64 whatever the
model's dtype (on an f32 kernel from its double-float Gram, csrc/gram_df.cu
on the card) and A is rounded to the model's dtype: with 16² inducing
points 1/15 apart and γ = 0.15 the f32 factor of Kzz fails at the default
jitter 1e-6, and the f32 fit's ELBO is NaN (chip_smoke.py phase 19.2 on
the CPU).
`rate_bands_linear_response` takes its Hessian by `torch.func.hessian`
(forward over reverse, as `jax.jacfwd(jax.grad(·))`) and tries the three
Newton candidates in a loop; its eigendecompositions run in float64
whatever the model's dtype, as the port's other small eighs do
(`opt/ellipsoid._eigh64`). `rate_bands_mcmc` runs on the port's
`inference/hmc`. Draws come from a `torch.Generator` through `_normal`.
The model lives on `device` (the card unless the caller passes another)
in the kernel's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.inference.hmc import hmc_sample
from stpy_tpu_torch.kernels.df_plan import gram64
from stpy_tpu_torch.linalg import chol_jittered, tri_solve

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _normal(generator, shape, dtype, device):
    where = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=where).to(device)


def _gauss_hermite(n=20, device=None, dtype=torch.float32):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (
        as_tensor(np.sqrt(2.0) * x, device=device, dtype=dtype),
        as_tensor(w / np.sqrt(np.pi), device=device, dtype=dtype),
    )


def _eigh64(H, like):
    w, V = torch.linalg.eigh(H.to(torch.float64))
    return w.to(like.dtype), V.to(like.dtype)


class SGCPVariational:
    def __init__(self, kernel_object, S, obs_points, num_inducing=32,
                 num_integration=128, lam_max_init=None, jitter=1e-6,
                 generator=None, device=None):
        """S: BorelSet domain; obs_points: (n, d) observed events."""
        self.kernel_object = kernel_object
        self.S = S
        self.device = resolve_device(device)
        self.dtype = kernel_object.dtype
        self.d = S.d
        self.X = (self._tensor(obs_points).reshape(-1, S.d)
                  if obs_points is not None else None)
        self.jitter = jitter
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(41)

        # inducing grid + integration rule over the domain
        per_dim = max(int(round(num_inducing ** (1.0 / self.d))), 2)
        self.Z = self._tensor(S.return_discretization(per_dim))
        self.M = self.Z.shape[0]
        q = max(int(round(num_integration ** (1.0 / self.d))), 4)
        int_w, int_x = S.return_legendre_discretization(q)
        self.int_w, self.int_x = self._tensor(int_w), self._tensor(int_x)

        n_obs = 0 if self.X is None else self.X.shape[0]
        vol = S.volume()
        lm0 = (
            lam_max_init
            if lam_max_init is not None
            else max(2.0 * n_obs / max(vol, 1e-9), 1.0)
        )
        self.params = {
            "m": torch.zeros((self.M,), dtype=self.dtype, device=self.device),
            "L_raw": torch.zeros((self.M, self.M), dtype=self.dtype,
                                 device=self.device),
            "log_lam": self._tensor(np.log(lm0)),
        }
        self._gh = _gauss_hermite(20, self.device, self.dtype)
        self._precompute()

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _precompute(self):
        ko = self.kernel_object
        Kzz = gram64(self.kernel_object, self.Z)
        self.Lz64 = chol_jittered(Kzz, self.jitter)
        self.Lz = self.Lz64.to(self.dtype)
        self.Kxz_obs = (
            gram64(self.kernel_object, self.X, self.Z).to(self.dtype)
            if self.X is not None else None
        )
        self.Kxz_int = gram64(self.kernel_object, self.int_x,
                              self.Z).to(self.dtype)
        self.kdiag_obs = (
            ko.diag(self.X) if self.X is not None else None
        )
        self.kdiag_int = ko.diag(self.int_x)
        self.A_obs = (self._whiten(self.Kxz_obs) if self.X is not None
                      else None)
        self.A_int = self._whiten(self.Kxz_int)

    def _whiten(self, Kxz):
        """A = Lz⁻¹ Kzx, (M, n), solved in float64 and returned in the
        model's dtype."""
        return tri_solve(self.Lz64, Kxz.T.to(torch.float64),
                         lower=True).to(self.dtype)

    def _eye(self):
        return torch.eye(self.M, dtype=self.dtype, device=self.device)

    # -- q(g(x)) marginals (whitened: u = Lz v, q(v) = N(m, Lq Lqᵀ)) ----------
    def _marginals_white(self, params, A, kdiag):
        m = params["m"]
        Lq = torch.tril(params["L_raw"]) + self._eye()
        mu = A.T @ m
        SA = Lq.T @ A                               # (M, n)
        var = (
            kdiag
            - torch.sum(A * A, dim=0)
            + torch.sum(SA * SA, dim=0)
        )
        return mu, torch.clamp(var, min=1e-10), Lq

    def _marginals(self, params, Kxz, kdiag):
        """mean/var of g at points with cross-cov Kxz to inducing set."""
        return self._marginals_white(params, self._whiten(Kxz), kdiag)

    def _elbo(self, params):
        gh_x, gh_w = self._gh
        lam = torch.exp(params["log_lam"])

        # data term Σ E[log σ(g_n)] + n log λ*
        data = 0.0
        if self.X is not None:
            mu_o, var_o, Lq = self._marginals_white(
                params, self.A_obs, self.kdiag_obs
            )
            g = mu_o[:, None] + torch.sqrt(var_o)[:, None] * gh_x[None, :]
            e_log_sig = torch.sum(gh_w[None, :] * (-Fn.softplus(-g)), dim=1)
            data = torch.sum(e_log_sig) + self.X.shape[0] * params["log_lam"]

        # integral term λ* ∫ E[σ(g)] (quadrature x Gauss-Hermite)
        mu_i, var_i, Lq = self._marginals_white(
            params, self.A_int, self.kdiag_int
        )
        g = mu_i[:, None] + torch.sqrt(var_i)[:, None] * gh_x[None, :]
        e_sig = torch.sum(gh_w[None, :] * torch.sigmoid(g), dim=1)
        integral = lam * torch.sum(self.int_w * e_sig)

        # KL(q(v) || N(0, I)) in whitened coordinates
        m = params["m"]
        trace = torch.sum(Lq * Lq)
        logdet_S = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(Lq))))
        kl = 0.5 * (trace + m @ m - self.M - logdet_S)
        return data - integral - kl

    def run(self, steps=500, lr=5e-2, verbose=False):
        """Maximize the ELBO with Adam (optax's update); returns the ELBO
        at the last step's iterate before its update, as the JAX scan."""
        names = list(self.params)
        p = {k: v.detach().clone() for k, v in self.params.items()}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        losses = []
        for t in range(1, steps + 1):
            leaves = {k: p[k].requires_grad_() for k in names}
            loss = -self._elbo(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            c1, c2 = 1.0 - ADAM_B1**t, 1.0 - ADAM_B2**t
            with torch.no_grad():
                for k, g in zip(names, grads):
                    mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                    nu[k] = (1 - ADAM_B2) * g**2 + ADAM_B2 * nu[k]
                    u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                    p[k] = p[k].detach() + (-lr) * u
            losses.append(loss.detach())
        self.params = {k: v.detach() for k, v in p.items()}
        if verbose:
            print("ELBO trace (neg):", [float(v) for v in losses[::50]])
        return float(-losses[-1])

    # -- posterior rate --------------------------------------------------------
    def _test_marginals(self, xtest):
        xtest = self._tensor(xtest).reshape(-1, self.d)
        Kxz = gram64(self.kernel_object, xtest, self.Z)
        kd = self.kernel_object.diag(xtest)
        return xtest, self._marginals(self.params, Kxz, kd)

    def sample_rate_points(self, xtest, size=1, generator=None):
        """Posterior rate samples λ* σ(g) with g ~ q."""
        xtest, (mu, var, _) = self._test_marginals(xtest)
        z = _normal(generator, (xtest.shape[0], size), mu.dtype, mu.device)
        g = mu[:, None] + torch.sqrt(var)[:, None] * z
        return torch.exp(self.params["log_lam"]) * torch.sigmoid(g)

    def rate_bands(self, xtest, delta=0.1, samples=256, generator=None):
        s = self.sample_rate_points(xtest, size=samples, generator=generator)
        return (
            torch.quantile(s, delta, dim=1),
            torch.quantile(s, 1 - delta, dim=1),
        )

    def mean_rate_points(self, xtest):
        """Deterministic posterior mean E_q[λ σ(g*)] by 1-D Gauss–Hermite
        over the marginal g* ~ N(μ*, σ*²)."""
        _, (mu, var, _) = self._test_marginals(xtest)
        gx, gw = self._gh  # nodes pre-scaled by sqrt(2), weights by 1/sqrt(pi)
        g = mu[:, None] + torch.sqrt(var)[:, None] * gx[None, :]
        ex = torch.sigmoid(g) @ gw
        return torch.exp(self.params["log_lam"]) * ex

    def rate_bands_exact(self, xtest, delta=0.1):
        """Exact posterior (δ, 1−δ) bands of the rate: λ σ(·) is monotone
        in g, so its quantiles are λ σ(μ ± z_δ σ)."""
        _, (mu, var, _) = self._test_marginals(xtest)
        z = float(torch.special.ndtri(torch.tensor(1.0 - delta,
                                                   dtype=torch.float64)))
        sd = torch.sqrt(var)
        lam = torch.exp(self.params["log_lam"])
        return (
            lam * torch.sigmoid(mu - z * sd),
            lam * torch.sigmoid(mu + z * sd),
        )

    # -- MCMC-corrected bands --------------------------------------------------
    def _whitened_log_posterior(self):
        """log p(v, log λ*, log c | data) over whitened inducing values
        (sparse plug-in model g(x) = c · A(x)ᵀ v), the max rate λ* and
        the prior amplitude c, state θ = [v, log λ*, log c]:

          Σ_n log σ(c·A_nᵀ v) + n·log λ* − λ* Σ_q w_q σ(c·A_qᵀ v)
            − ½‖v‖² − ½ log²c
        """
        A_obs, A_int = self.A_obs, self.A_int
        n_obs = 0 if self.X is None else self.X.shape[0]
        w = self.int_w

        def log_prob(theta):
            v, log_lam, log_c = theta[:-2], theta[-2], theta[-1]
            lam = torch.exp(log_lam)
            c = torch.exp(log_c)
            lp = -0.5 * (v @ v) - 0.5 * log_c * log_c
            if A_obs is not None:
                lp = lp + torch.sum(-Fn.softplus(-(c * (A_obs.T @ v))))
                lp = lp + n_obs * log_lam
            lp = lp - lam * torch.sum(w * torch.sigmoid(c * (A_int.T @ v)))
            return lp

        return log_prob

    def rate_bands_mcmc(self, xtest, delta=0.1, samples=600, warmup=300,
                        step_size=0.05, leapfrog_steps=25, generator=None):
        """(δ, 1−δ) bands of λ(x) from HMC over the sparse posterior; the
        residual conditional variance kdiag − ‖A*‖² is added as
        independent Gaussian noise per sample. Returns (lo, hi,
        accept_rate)."""
        generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(7)
        log_prob = self._whitened_log_posterior()
        # start at the VI mean — already near the mode
        theta0 = torch.cat(
            [self.params["m"], self.params["log_lam"].reshape(1),
             torch.zeros((1,), dtype=self.dtype, device=self.device)]
        )
        thetas, acc = hmc_sample(
            generator, log_prob, theta0, steps=warmup + samples,
            leapfrog_steps=leapfrog_steps, step_size=step_size,
            burn_in=warmup,
        )
        vs, log_lams, log_cs = (
            thetas[:, :-2], thetas[:, -2], thetas[:, -1]
        )
        xtest = self._tensor(xtest).reshape(-1, self.d)
        kd = self.kernel_object.diag(xtest)
        A = self._whiten(gram64(self.kernel_object, xtest, self.Z))  # (M, t)
        resid_sd = torch.sqrt(torch.clamp(kd - torch.sum(A * A, dim=0),
                                          min=0.0))
        cs = torch.exp(log_cs)[:, None]
        g = cs * (vs @ A)                                  # (S, t)
        eps = _normal(generator, g.shape, g.dtype, g.device)
        g = g + cs * (eps * resid_sd[None, :])
        rate = torch.exp(log_lams)[:, None] * torch.sigmoid(g)
        return (
            torch.quantile(rate, delta, dim=0),
            torch.quantile(rate, 1 - delta, dim=0),
            float(acc),
        )

    # -- deterministic corrected bands -----------------------------------------
    def _elbo_extended(self, theta, Lq_fixed):
        """ELBO as a function of the mean parameters θ = [m, log λ*, log c]
        with the variational covariance Lq frozen at the VI optimum and a
        kernel-amplitude multiplier c on the g marginals: the objective
        whose curvature defines the linear-response covariance."""
        gh_x, gh_w = self._gh
        M = self.M
        m, log_lam, log_c = theta[:M], theta[M], theta[M + 1]
        lam = torch.exp(log_lam)
        c = torch.exp(log_c)

        def marginals(A, kdiag):
            mu = c * (A.T @ m)
            SA = Lq_fixed.T @ A
            var = (c * c) * torch.clamp(
                kdiag - torch.sum(A * A, dim=0) + torch.sum(SA * SA, dim=0),
                min=1e-10)
            return mu, var

        data = 0.0
        if self.X is not None:
            mu_o, var_o = marginals(self.A_obs, self.kdiag_obs)
            g = mu_o[:, None] + torch.sqrt(var_o)[:, None] * gh_x[None, :]
            data = torch.sum(gh_w[None, :] * (-Fn.softplus(-g))) \
                + self.X.shape[0] * log_lam
        mu_i, var_i = marginals(self.A_int, self.kdiag_int)
        g = mu_i[:, None] + torch.sqrt(var_i)[:, None] * gh_x[None, :]
        e_sig = torch.sum(gh_w[None, :] * torch.sigmoid(g), dim=1)
        integral = lam * torch.sum(self.int_w * e_sig)
        # m-dependent KL part + N(0,1) prior on log c (the trace/logdet
        # KL terms are constants in θ here)
        kl = 0.5 * (m @ m) + 0.5 * log_c * log_c
        return data - integral - kl

    def rate_bands_linear_response(self, xtest, delta=0.1, newton_steps=20):
        """(δ, 1−δ) bands from the linear-response covariance at the VI
        optimum: Σ_LR = (−∇²_θ ELBO)⁻¹ over the mean parameters
        θ = [m, log λ*, log c] after a damped Newton to the joint optimum,
        propagated through g = c·aᵀm and added to q's own marginal
        variance; quantiles of λ*σ(g) off a weighted 16×16 Gauss-Hermite
        lattice over the joint (g, log λ*) Gaussian."""
        M = self.M
        Lq_fixed = torch.tril(self.params["L_raw"]) + self._eye()

        def nF(t):
            return -self._elbo_extended(t, Lq_fixed)

        grad_nF = torch.func.grad(nF)
        hess_nF = torch.func.hessian(nF)
        theta = torch.cat(
            [self.params["m"], self.params["log_lam"].reshape(1),
             torch.zeros((1,), dtype=self.dtype, device=self.device)]
        )
        eye = torch.eye(M + 2, dtype=self.dtype, device=self.device)

        # damped Newton to the joint optimum (the VI fit is its stationary
        # point in m and log λ*; log c re-optimizes in a couple of steps)
        for _ in range(max(1, newton_steps)):
            g = grad_nF(theta)
            H = hess_nF(theta)
            H = 0.5 * (H + H.T) + 1e-6 * eye
            lam_e, V_e = _eigh64(H, theta)
            lam_e = torch.clamp(lam_e, min=1e-5)      # PSD-guarded step
            step = V_e @ ((V_e.T @ g) / lam_e)
            with torch.no_grad():
                cands = [theta - s * step for s in (1.0, 0.5, 0.25)]
                vals = torch.stack([nF(c) for c in cands])
                best = torch.argmin(vals)
                better = vals[best] < nF(theta)
                theta = torch.where(better, torch.stack(cands)[best], theta)
        H = hess_nF(theta)
        H = 0.5 * (H + H.T)
        # PSD-guarded inverse: clip the response spectrum at a small
        # positive floor
        lam_e, V_e = _eigh64(H, theta)
        lam_e = torch.clamp(lam_e, min=1e-5)
        Sigma = (V_e / lam_e[None, :]) @ V_e.T

        m_opt, log_c = theta[:M], theta[M + 1]
        c = torch.exp(log_c)

        xtest = self._tensor(xtest).reshape(-1, self.d)
        kd = self.kernel_object.diag(xtest)
        A = self._whiten(gram64(self.kernel_object, xtest, self.Z))  # (M, t)
        SA = Lq_fixed.T @ A
        # q's own marginal variance of g (the MFVI band's spread) ...
        var_q = (c * c) * torch.clamp(
            kd - torch.sum(A * A, dim=0) + torch.sum(SA * SA, dim=0), min=0.0)

        g_mean = c * (A.T @ m_opt)                          # (t,)
        # ... plus the linear-response covariance of the fit, propagated
        # through the exact Jacobian of g = c·aᵀm: [c·a (m rows), 0 (ℓ),
        # g (log c)]; ℓ = log λ* is coordinate M
        Jg_v = c * A                                        # (M, t)
        SvJ = Sigma[:M, :M] @ Jg_v                          # (M, t)
        var_g = (
            var_q
            + torch.sum(Jg_v * SvJ, dim=0)
            + 2.0 * g_mean * (Sigma[:M, M + 1] @ Jg_v)
            + g_mean**2 * Sigma[M + 1, M + 1]
        )
        cov_gl = Sigma[:M, M] @ Jg_v + g_mean * Sigma[M + 1, M]
        var_l = Sigma[M, M]
        l_mean = theta[M]

        # quantiles of exp(ℓ)·σ(g) over the per-point 2-D Gaussian by a
        # weighted tensor Gauss-Hermite lattice (16×16): sort node values,
        # accumulate weights, pick the δ / 1−δ crossings
        gx, gw = _gauss_hermite(16, self.device, self.dtype)
        z1 = torch.repeat_interleave(gx, gx.shape[0])
        z2 = gx.repeat(gx.shape[0])
        wts = (gw[:, None] * gw[None, :]).reshape(-1)
        sd_g = torch.sqrt(torch.clamp(var_g, min=1e-12))
        sd_l = torch.sqrt(torch.clamp(var_l, min=1e-12))
        rho = torch.clamp(
            cov_gl / torch.clamp(sd_g * sd_l, min=1e-12), -0.999, 0.999)
        g_nodes = g_mean[:, None] + sd_g[:, None] * z1[None, :]
        l_nodes = l_mean + sd_l * (
            rho[:, None] * z1[None, :]
            + torch.sqrt(torch.clamp(1 - rho**2, min=1e-12))[:, None]
            * z2[None, :]
        )
        rate = torch.exp(l_nodes) * torch.sigmoid(g_nodes)   # (t, 256)

        order = torch.argsort(rate, dim=1, stable=True)
        sorted_rate = torch.gather(rate, 1, order)
        sorted_w = torch.cumsum(wts[order], dim=1)

        def pick(q):
            idx = torch.argmax((sorted_w >= q).to(torch.int32), dim=1)
            return torch.gather(sorted_rate, 1, idx[:, None])[:, 0]

        return pick(delta), pick(1.0 - delta)

    @property
    def lam_max(self):
        return float(torch.exp(self.params["log_lam"]))


# reference-compatible alias
VMF_SGCP = SGCPVariational
