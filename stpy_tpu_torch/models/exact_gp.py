"""Exact Gaussian-process regression on the card.

Port of stpy_tpu/models/exact_gp.py for the exact-GP serving path:

* single tier (``precision="single"``): fused Gram (csrc/gram.cu) → add s²I
  → jitter-ladder Cholesky → solve for alpha → cross Gram → mean K*·alpha →
  triangular solve → variance k** − Σ V²;
* double tier (``precision="double"``, ``var_refine=0``): double-float
  (hi, lo) Gram (csrc/gram_df.cu) → Cholesky of the hi part + s²I →
  iterative refinement of alpha as a df pair with exact df GEMV residuals
  (csrc/gemv_df.cu) → df predictive mean → variance through the hi part;
* refined double tier (``var_refine >= 1``): the same fit, keeping the train
  df Gram → df mean → df k** → one solve W0 = (L Lᵀ)⁻¹ K*ᵀ → the fused df
  quadratic form q (csrc/qform_df.cu) → variance k** − q in float64.

The models run on the card unless ``device="cpu"`` is passed (or a kernel
that lives on the CPU).

It also fits hyperparameters on the evidence (`optimize_params`,
`log_marginal`, through `Estimator.optimize_params_general`), differentiating
through the hand Grams' autograd Functions, and samples the posterior
(`sample`, `log_probability`).

PyTorch runs eagerly, so the JAX package's jitted closures become plain
methods. Everything else the JAX model offers raises NotImplementedError
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import math

import torch

from stpy_tpu_torch.config import as_tensor, default_jitter
from stpy_tpu_torch.kernels import KernelFunction
from stpy_tpu_torch.kernels.df_plan import (
    df_atom_desc,
    df_diag_from_desc,
    df_gram_from_desc,
)
from stpy_tpu_torch.linalg import (
    cho_solve,
    cho_solve_blocked,
    chol_jittered,
    logdet_from_chol,
    safe_cholesky,
    tri_solve_blocked,
)
from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.ops.gemv_df import gemv_df
from stpy_tpu_torch.ops.qform_df import qform_refined


class GaussianProcess(Estimator):
    def __init__(
        self, gamma=1.0, s=0.001, kappa=1.0,
        kernel_name="squared_exponential", diameter=1.0, groups=None,
        bounds=None, nu=1.5, kernel=None, d=1, power=2, lam=1.0,
        loss="squared", huber_delta=1.35, hyper="classical", B=1.0,
        svr_eps=0.1, var_precision=None, precision="single", var_refine=0,
        jitter_ladder=True, df_refine_steps=None, qform_precision=None,
        fold_noise=False, device=None, dtype=None,
    ):
        if precision not in ("single", "double"):
            raise ValueError(f"precision must be single|double, got {precision}")
        if var_refine and precision != "double":
            raise ValueError("var_refine requires precision='double'")
        if jitter_ladder not in (True, False, "recompute"):
            raise ValueError(
                "jitter_ladder must be True, False, or 'recompute', "
                f"got {jitter_ladder!r}"
            )
        if fold_noise and precision != "double":
            raise ValueError("fold_noise requires precision='double'")
        if fold_noise and jitter_ladder is not False:
            raise ValueError("fold_noise requires jitter_ladder=False")
        if jitter_ladder == "recompute":
            raise NotImplementedError(
                "jitter_ladder='recompute' is ROADMAP Queue 1 item 13 (ported "
                "once a memory measurement on the card shows the need)"
            )
        if fold_noise:
            raise NotImplementedError(
                "fold_noise is ROADMAP Queue 1 item 13 (ported once a memory "
                "measurement on the card shows the need)"
            )
        if loss != "squared":
            raise NotImplementedError(
                f"robust loss {loss!r} is ROADMAP Queue 1 item 6"
            )
        # var_precision and qform_precision pick TPU matmul pass counts;
        # they are accepted for signature parity and have no effect here
        self._precision = precision
        self._var_refine = int(var_refine)   # any value >= 1 acts as 1
        self._jitter_ladder = jitter_ladder
        self.s = s
        self.d = d
        self.x = None
        self.y = None
        self.mu = 0.0
        self.lam = lam
        self.total_bound = B
        self.prob = 0.5
        self.svr_eps = svr_eps
        self.fitted = False
        self.diameter = diameter
        self.bounds = bounds
        self.admits_first_order = False
        self.loss = loss
        self.huber_delta = huber_delta
        self.hyper = hyper
        self.beta_mult = 2.0  # ucb/lcb multiplier (reference hard-codes 2)

        if kernel is not None:
            if device is not None and torch.device(device) != kernel.device:
                raise ValueError(
                    f"device={device} disagrees with the kernel's {kernel.device}")
            if dtype is not None and dtype != kernel.dtype:
                raise ValueError(
                    f"dtype={dtype} disagrees with the kernel's {kernel.dtype}")
            self.kernel_object = kernel
            self.d = kernel.d
        else:
            self.kernel_object = KernelFunction(
                kernel_name=kernel_name, gamma=gamma, nu=nu, groups=groups,
                kappa=kappa, power=power, d=d, device=device,
                dtype=torch.float32 if dtype is None else dtype,
            )
        self.device = self.kernel_object.device
        self.dtype = self.kernel_object.dtype
        self.kernel = self.kernel_object.kernel  # reference-convention callable
        self.L = self.A = self._A_df = self._df_train = None
        self.fit_status = None
        self._df_desc = None
        if precision == "double":
            self._df_desc = df_atom_desc(self.kernel_object)
            # every ported atom is a fused df family: one exact-residual
            # step lands on the df representation floor
            # (stpy_tpu/models/exact_gp.py:209-211)
            self._df_refine_steps_resolved = (
                1 if df_refine_steps is None else max(0, int(df_refine_steps)))

    # -- descriptions ----------------------------------------------------------
    def description(self):
        return self.kernel_object.description() + "\nlambda=" + str(self.s)

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    # -- fitting ---------------------------------------------------------------
    def _factor(self, A):
        """(L, ok, jitter) of A by the configured jitter policy."""
        if self._jitter_ladder:
            res = safe_cholesky(A)
            return res.L, res.ok, res.jitter
        L = chol_jittered(A)
        jitter = default_jitter(A.dtype) * torch.mean(torch.diagonal(A))
        return L, torch.isfinite(L).all(), jitter

    def _fit_single(self, x, y):
        pd = self.kernel_object.params_dict
        K = self.kernel_object.eval_params(pd, x, x)
        # no (K+K.T)/2: Cholesky reads only the lower triangle and the fused
        # Gram is symmetric by construction. s²I goes onto the fresh Gram's
        # diagonal in place, which saves an n² copy (1 GiB at n = 16k, f32).
        K.diagonal().add_(self.s * self.s)
        L, ok, jitter = self._factor(K)
        return L, cho_solve(L, y), ok, jitter

    def _df_gram(self, a, b):
        Kh, Kl = df_gram_from_desc(self.kernel_object,
                                   self.kernel_object.params_dict, a, b,
                                   self._df_desc)
        # the pair is f32; a float64 model (CPU tests) holds the same values
        return Kh.to(self.dtype), Kl.to(self.dtype)

    def _fit_double(self, x, y):
        Kh, Kl = self._df_gram(x, x)
        A = Kh.clone()
        A.diagonal().add_(self.s * self.s)
        L, ok, jitter = self._factor(A)
        del A
        # refinement with an EXACT residual y − (Kh + Kl + s²I)·α and alpha
        # carried as a df pair: a single-f32 alpha caps the posterior mean
        # at eps·‖K*‖‖α‖/‖μ‖. The n² product is the df GEMV kernel; the O(n)
        # terms around it run in float64, where the JAX package needs
        # TwoSum/TwoProd because the TPU has no f64.
        f64 = torch.float64
        y64, s2 = y.to(f64), self.s * self.s
        a_h = cho_solve_blocked(L, y)
        a_l = torch.zeros_like(a_h)
        for _ in range(self._df_refine_steps_resolved):
            Ph, Pl = gemv_df(Kh, Kl, a_h, vl=a_l)
            alpha = a_h.to(f64) + a_l.to(f64)
            r = y64 - (Ph.to(f64) + Pl.to(f64))[:, None] - s2 * alpha
            alpha += cho_solve_blocked(L, r.to(self.dtype)).to(f64)
            a_h = alpha.to(self.dtype)
            a_l = (alpha - a_h.to(f64)).to(self.dtype)
        # the refined predict's quadratic form reads the train df Gram
        df_train = (Kh, Kl) if self._var_refine else None
        return L, torch.cat([a_h, a_l], dim=1), ok, jitter, df_train

    def _fit(self, x, y):
        if self._precision == "double":
            return self._fit_double(x, y)
        return self._fit_single(x, y)

    def _set_data(self, x, y):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.n, self.d = x.shape
        self.x, self.y = x, y
        # release the previous fit's factors BEFORE computing the new ones:
        # holding the old (n, n) L across a refit adds a full n² to the peak
        self.L = self.A = self._A_df = self._df_train = None
        self.fitted = False
        return x, y

    def _store_fit(self, L, alpha, ok, jitter, df_train=None):
        self.L = L
        self._df_train = df_train
        if self._precision == "double":
            # alpha is an (n, 2) df pair; self.A keeps the (n, 1) hi column
            # for every single-precision consumer
            self._A_df = alpha
            self.A = alpha[:, :1]
        else:
            self.A = alpha
        self.fit_status = {
            "cholesky_ok": bool(ok),
            "jitter_used": float(jitter),
            "n": int(self.n),
        }
        self.fitted = True

    def fit_gp(self, x, y, Sigma=None, iterative=False, extrapoint=False):
        """Fit the GP: Gram + jittered Cholesky + solve. `Sigma` optionally
        gives a per-point noise std matrix (K += ΣᵀΣ as in
        gauss_procc.py:163); default is isotropic s."""
        x, y = self._set_data(x, y)
        if Sigma is None:
            self._store_fit(*self._fit(x, y))
            return None
        if self._precision == "double":
            raise NotImplementedError(
                "per-point Sigma noise is not supported with "
                "precision='double' (the df fit models isotropic s "
                "only); use precision='single'"
            )
        Sigma = self._tensor(Sigma)
        K = self.kernel_object.gram(x) + Sigma.T @ Sigma
        L, ok, jitter = self._factor(K)
        self._store_fit(L, cho_solve(L, y), ok, jitter)
        return None

    def fit(self, x=None, y=None):
        if x is not None:
            self.fit_gp(x, y)
        else:
            self.fit_gp(self.x, self.y)

    def fit_predict(self, x, y, xtest):
        """Fit, then the posterior (mu, std) at `xtest`; state is stored
        exactly as after fit_gp(x, y)."""
        x, y = self._set_data(x, y)
        xtest = self._tensor(xtest)
        self._store_fit(*self._fit(x, y))
        return self._predict(xtest)

    # -- prediction ------------------------------------------------------------
    def _variance_std(self, kss, V):
        var = torch.clamp(kss - V.square_().sum(dim=0), min=1e-30)
        return torch.sqrt(var)[:, None]

    def _predict(self, xtest):
        if self._var_refine:
            return self._predict_refined(xtest)
        ko, pd = self.kernel_object, self.kernel_object.params_dict
        kss = ko.diag(xtest, pd)
        if self._precision == "double":
            Kh, Kl = self._df_gram(xtest, self.x)                 # (t, n)
            Mh, Ml = gemv_df(Kh, Kl, self._A_df[:, :1],
                             vl=self._A_df[:, 1:])
            del Kl
            mu = (Mh + Ml)[:, None]
            V = tri_solve_blocked(self.L, Kh.T)                   # (n, t)
        else:
            K_star = ko.eval_params(pd, xtest, self.x)            # (t, n)
            mu = K_star @ self.A
            V = tri_solve_blocked(self.L, K_star.T)
        return mu, self._variance_std(kss, V)

    def _predict_refined(self, xtest):
        """var_refine >= 1: the variance from the fused df quadratic form
        q = Σ W0 ⊙ (2B − (Th + Tl)·W0 − s²W0), whose error is second order
        in W0's solve residual (ops/qform_df.py), so one f32 solve for W0
        suffices. k** − q is formed in float64 where the JAX package needs
        TwoSum."""
        Kh, Kl = self._df_gram(xtest, self.x)                     # (t, n)
        Mh, Ml = gemv_df(Kh, Kl, self._A_df[:, :1], vl=self._A_df[:, 1:])
        mu = (Mh + Ml)[:, None]
        ksh, ksl = df_diag_from_desc(self.kernel_object,
                                     self.kernel_object.params_dict, xtest,
                                     self._df_desc)
        W0 = cho_solve_blocked(self.L, Kh.T)                      # (n, t)
        Th, Tl = self._df_train
        qh, ql = qform_refined(Th, Tl, W0, Kh.T, Kl.T, self.s)
        del W0, Kh, Kl
        f64 = torch.float64
        var = (ksh.to(f64) + ksl.to(f64)) - (qh.to(f64) + ql.to(f64))
        return mu, torch.sqrt(torch.clamp(var, min=1e-30)).to(self.dtype)[:, None]

    def _predict_full(self, xtest):
        ko, pd = self.kernel_object, self.kernel_object.params_dict
        K_star = ko.eval_params(pd, xtest, self.x)
        mu = K_star @ self.A
        V = tri_solve_blocked(self.L, K_star.T)
        Kss = ko.eval_params(pd, xtest, xtest)
        return mu, Kss - V.T @ V

    def mean_std(self, xtest, full=False, reuse=False):
        xtest = self._tensor(xtest)
        if not self.fitted:
            zero = torch.zeros((xtest.shape[0], 1), dtype=self.dtype,
                               device=self.device)
            if full:
                return zero, self.kernel_object.gram(xtest)
            return zero, torch.sqrt(self.kernel_object.diag(xtest))[:, None]
        if full:
            return self._predict_full(xtest)
        return self._predict(xtest)

    def mean(self, xtest):
        return self.mean_std(xtest)[0]

    def beta(self, delta=1e-3, norm=1):
        """Concentration parameter (parity: gauss_procc.py:186-193, via the
        Cholesky logdet)."""
        logdet = logdet_from_chol(self.L)
        inner = 1.0 / delta + (logdet - 2 * self.n * math.log(self.s))
        return self.s * norm + torch.sqrt(
            2.0 * torch.log(torch.clamp(inner, min=1.0 + 1e-9)))

    def ucb(self, xtest):
        mu, s = self.mean_std(xtest)
        return mu + self.beta_mult * s

    def lcb(self, xtest):
        mu, s = self.mean_std(xtest)
        return mu - self.beta_mult * s

    # -- sampling ----------------------------------------------------------------
    def _gram64(self, a, b):
        """The Gram K(a, b) in float64 for `_moments64`: on a model narrower
        than float64, from the double-float Gram (csrc/gram_df.cu on the
        card) where every atom is a df family, else the model's Gram
        promoted."""
        ko, pd = self.kernel_object, self.kernel_object.params_dict
        f64 = torch.float64
        if self.dtype != f64:
            try:
                desc = self._df_desc or df_atom_desc(ko)
            except NotImplementedError:   # laplace, composites outside df
                desc = None
            if desc is not None:
                Kh, Kl = df_gram_from_desc(ko, pd, a, b, desc)
                return Kh.to(f64) + Kl.to(f64)
        return ko.eval_params(pd, a, b).to(f64)

    def _moments64(self, xtest):
        """(mean, covariance) at `xtest` in float64, for `sample` and
        `log_probability`: the posterior's through the fitted factor L and
        alpha, the prior's if unfitted. The posterior variance of points a
        few noise lengths apart is a small remainder of k** − VᵀV, below
        the f32 Gram's rounding: on `benchmarks/run_all.py` config 1 at 256
        points of [−1, 1] the f32 covariance has a least eigenvalue of −19 %
        of its mean variance (an H100), −2.3 % with only the algebra in
        float64 (the CPU), past the jitter ladder's 1e-2 of the mean
        variance. With k** and K* in float64 it is the posterior covariance
        under the fitted L Lᵀ, PSD there to float64's rounding. On a float64
        single-tier model it is `mean_std(full=True)`'s arithmetic."""
        f64 = torch.float64
        xtest = self._tensor(xtest)
        if not self.fitted:
            mean = torch.zeros((xtest.shape[0], 1), dtype=f64,
                               device=self.device) + self.mu
            return mean, self._gram64(xtest, xtest)
        Ks = self._gram64(xtest, self.x)                          # (t, n)
        alpha = self.A if self._A_df is None else self._A_df
        mean = Ks @ alpha.to(f64).sum(dim=1, keepdim=True)
        V = tri_solve_blocked(self.L.to(f64), Ks.T)
        return mean, self._gram64(xtest, xtest) - V.T @ V

    def _factor64(self, cov, jitter=None):
        """The jitter-ladder factor of `_moments64`'s covariance; raises
        where the ladder fails rather than returning a NaN factor."""
        res = safe_cholesky(cov, jitter=jitter)
        if not bool(res.ok):
            raise RuntimeError(
                "the posterior covariance is not positive definite even "
                f"with jitter {float(res.jitter)!r} on its diagonal; pass a "
                "larger `jitter`")
        return res

    def sample(self, xtest, size=1, jitter=1e-8, generator=None):
        """Posterior (or prior if unfitted) path samples on a grid:
        mean + L·z with L the jitter-ladder Cholesky factor of the full
        covariance, both from `_moments64`, and z standard normals of the
        model's dtype drawn from `generator` (torch's default generator
        where None) on the generator's device. Returns the model's dtype;
        raises if the ladder fails."""
        mean, cov = self._moments64(xtest)
        L = self._factor64(cov, jitter).L
        where = self.device if generator is None else generator.device
        z = torch.randn((mean.shape[0], size), generator=generator,
                        dtype=self.dtype, device=where).to(self.device)
        return (mean + L @ z.to(torch.float64)).to(self.dtype)

    def log_probability(self, xtest, sample):
        """log N(sample; μ, Σ) of the posterior at `xtest`, on
        `_moments64`'s mean and covariance."""
        mu, cov = self._moments64(xtest)
        n = mu.shape[0]
        L = self._factor64(cov).L
        diff = as_tensor(sample, device=self.device,
                         dtype=torch.float64).reshape(-1, 1) - mu
        alpha = cho_solve(L, diff)
        return float(-0.5 * (diff.T @ alpha)[0, 0]
                     - 0.5 * logdet_from_chol(L)
                     - 0.5 * n * math.log(2 * math.pi))

    # -- hyperparameter presets (parity: gauss_procc.py:640-697) -----------------
    def optimize_params(
        self, type="bandwidth", restarts=10, regularizer=None, maxiter=200,
        mingradnorm=1e-6, verbose=False, optimizer="lbfgs", scale=1.0,
        weight=1.0, save=False, save_name="model.np", init_func=None,
        bounds=None, generator=None,
        **hyperopt_kwargs,
    ):
        """Fit the kernel's bandwidths (`type="bandwidth"`), bandwidths and
        noise (`"bandwidth+noise"`) or amplitudes (`"kappa"`) on the
        evidence by `optimize_params_general`, then refit.
        `regularizer=("spectral_norm" | "lasso", λ)` adds
        λ·Σ|exp(−raw)|."""
        regularizer_func = None
        if regularizer is not None:
            kind, lam_r = regularizer[0], regularizer[1]
            if kind in ("spectral_norm", "lasso"):
                def regularizer_func(xf):
                    return lam_r * torch.sum(torch.abs(1.0 / torch.exp(xf)))

        pdict = self.kernel_object.params_dict
        params = {}
        if type in ("bandwidth", "bandwidth+noise"):
            for pkey, d2 in pdict.items():
                for var in ("gamma", "ard_gamma"):
                    if var in d2:
                        params[pkey] = {var: (init_func, None, bounds)}
                        break
            if type == "bandwidth+noise":
                params["likelihood"] = {
                    "sigma": ((lambda sz: self.s), None, None)}
        elif type == "kappa":
            for pkey, d2 in pdict.items():
                if "kappa" in d2:
                    params[pkey] = {"kappa": (init_func, None, bounds)}
        elif type in ("covariance", "rots"):
            raise NotImplementedError(
                f"type={type!r}: the manifold fits of a full-covariance "
                "kernel come with opt/manifold (ROADMAP Queue 1 item 9)")
        elif type == "groups":
            raise NotImplementedError(
                "type='groups': additive-group selection comes with the "
                "kernel tail's groups (ROADMAP Queue 1 item 7)")
        else:
            raise AttributeError("This quick-optimization is not implemented.")

        return self.optimize_params_general(
            params=params, restarts=restarts, optimizer=optimizer,
            regularizer_func=regularizer_func, maxiter=maxiter,
            mingradnorm=mingradnorm, verbose=verbose, scale=scale,
            weight=weight, save=save, save_name=save_name,
            generator=generator, **hyperopt_kwargs,
        )

    # -- not ported yet ----------------------------------------------------------
    def ucb_optimize(self, *args, **kwargs):
        raise NotImplementedError("ucb_optimize is ROADMAP Queue 1 item 6")
