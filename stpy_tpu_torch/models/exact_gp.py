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
(`sample`, `log_probability`, `sample_and_max`, `sample_iteratively_max`).
The robust losses (``loss="huber" | "svr" | "unif" | "unif_new"``) fit a MAP
alpha by L-BFGS with the zoom line search and their evidence is the
Laplace/Danskin construction (`_log_marginal_map`). The BO helpers
(`ucb_optimize`, `gradient_mean_var`, `mean_gradient_hessian`) differentiate
the posterior in the points through `ops.gram._Gram`; `volume_mean` fits the
adversarially robust mean by FISTA or L-BFGS.

PyTorch runs eagerly, so the JAX package's jitted closures become plain
methods, and where the JAX method takes a `key` the port takes a
`torch.Generator` (`generator=`). `optimize_params(type="groups")` searches
the additive group structures (`Estimator._optimize_discrete`), and
`type="covariance" | "rots"` fits a full-covariance kernel's `cov` on the
PSD or Stiefel manifold (opt/manifold.py).
"""

from __future__ import annotations

import math

import numpy as np
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
    tri_solve,
    tri_solve_blocked,
)
from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.ops.gemv_df import gemv_df
from stpy_tpu_torch.ops.qform_df import qform_refined
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.opt.manifold import optimize_psd, optimize_stiefel
from stpy_tpu_torch.opt.prox import fista_prox_backtracking
from stpy_tpu_torch.opt.scalar import bisection
from stpy_tpu_torch.utils.groups import generate_groups


def _softplus(x):
    """log(1 + eˣ) over the whole range, as `jax.nn.softplus`:
    `torch.nn.functional.softplus` returns x itself above its threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


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
            # the JAX package's default (stpy_tpu/models/exact_gp.py:209-211):
            # one exact-residual step lands a fused family on the df floor;
            # three where an atom is generic
            generic = any(d[1] == "generic" for d in self._df_desc)
            self._df_refine_steps_resolved = (
                (3 if generic else 1) if df_refine_steps is None
                else max(0, int(df_refine_steps)))

    # -- descriptions ----------------------------------------------------------
    def description(self):
        return self.kernel_object.description() + "\nlambda=" + str(self.s)

    def embed(self, x):
        return self.kernel_object.embed(x)

    def get_basis_size(self):
        return self.kernel_object.get_basis_size()

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
            self._fit_robust()
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
        self._fit_robust()
        return None

    def _fit_robust(self):
        """A robust loss replaces the fitted alpha by its MAP alpha; the
        double tier's df mean then reads it with a zero lo column (the 1e-6
        story holds for the squared loss only)."""
        if self.loss == "squared":
            return
        self.A = self._robust_alpha()
        if self._precision == "double":
            self._A_df = torch.cat([self.A, torch.zeros_like(self.A)], dim=1)

    def fit(self, x=None, y=None):
        if x is not None:
            self.fit_gp(x, y)
        else:
            self.fit_gp(self.x, self.y)

    def fit_predict(self, x, y, xtest):
        """Fit, then the posterior (mu, std) at `xtest`; state is stored
        exactly as after fit_gp(x, y)."""
        if self.loss != "squared":
            self.fit_gp(x, y)
            return self.mean_std(xtest)
        x, y = self._set_data(x, y)
        xtest = self._tensor(xtest)
        self._store_fit(*self._fit(x, y))
        return self._predict(xtest)

    def add_data_point(self, x, y, Sigma=None):
        x, y = self._tensor(x), self._tensor(y).reshape(-1, 1)
        if self.x is not None:
            x, y = torch.cat([self.x, x]), torch.cat([self.y, y])
        self.fit_gp(x, y, Sigma=Sigma)

    # -- robust-loss alpha fits (gauss_procc.py:211-289) -------------------------
    def _loss_objective(self, K, y):
        """The robust loss's objective in alpha (1-D) on the Gram K."""
        s, lam = self.s, self.lam
        yv = y.reshape(-1)
        if self.loss == "huber":
            delta = self.huber_delta

            def obj(alpha):
                Ka = K @ alpha
                a = torch.abs((Ka - yv) / s)
                hub = torch.where(a <= delta, 0.5 * a ** 2,
                                  delta * (a - 0.5 * delta))
                return torch.sum(hub) + lam * (alpha @ Ka)

            return obj
        if self.loss == "svr":
            eps_i = self.svr_eps

            def obj(alpha):
                Ka = K @ alpha
                r = torch.abs(Ka - yv) - eps_i
                # a smoothed hinge (softplus sharpness 50)
                return torch.sum(_softplus(50.0 * r) / 50.0) + lam * (
                    alpha @ Ka)

            return obj
        if self.loss in ("unif", "unif_new"):
            con = (2 * self.total_bound * self.prob
                   / ((1 - self.prob) * np.sqrt(2 * np.pi * s ** 2)))

            def obj(alpha):
                r = (K @ alpha - yv) ** 2 / (2 * s ** 2)
                return torch.sum(_softplus(r + np.log(con))) + lam * (
                    alpha @ alpha)

            return obj
        raise AssertionError("Loss function not implemented.")

    def _robust_alpha(self):
        """The MAP alpha of the robust loss: L-BFGS (zoom line search) from
        zero, at most 500 iterations; its iterations and `converged` are
        kept in `robust_status`."""
        K = self.kernel_object.gram(self.x)
        obj = self._loss_objective(K, self.y)
        res = minimize_lbfgs(obj, torch.zeros(self.n, dtype=K.dtype,
                                              device=K.device), max_iter=500)
        self.robust_status = {"iterations": res.iterations,
                              "converged": res.converged,
                              "value": float(res.value)}
        return res.x[:, None]

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

    def execute(self, xtest):
        xtest = self._tensor(xtest)
        K_star = (self.kernel_object.cross(self.x, xtest).T if self.fitted
                  else None)
        return K_star, self.kernel_object.gram(xtest)

    def residuals(self, x, y):
        return self.mean(x) - self._tensor(y).reshape(-1, 1)

    def norm(self):
        if not self.fitted:
            return None
        K = self.kernel_object.gram(self.x)
        return torch.sqrt(self.A.T @ K @ self.A)[0, 0]

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
        card for the fused families, float64 torch ops for the others),
        else the model's own Gram."""
        ko, pd = self.kernel_object, self.kernel_object.params_dict
        f64 = torch.float64
        if self.dtype != f64:
            Kh, Kl = df_gram_from_desc(ko, pd, a, b,
                                       self._df_desc or df_atom_desc(ko))
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

    def sample_and_max(self, xtest, size=1, generator=None):
        """`size` posterior paths at `xtest` (`sample`) and, per path, its
        argmax point and maximum."""
        xtest = self._tensor(xtest)
        f = self.sample(xtest, size=size, generator=generator)
        return xtest[torch.argmax(f, dim=0), :], torch.max(f, dim=0).values

    def sample_iteratively_max(self, xtest, multistart=20,
                               minimizer="coordinate-wise", grid=100,
                               generator=None):
        """Thompson-style maximum of a posterior path (gauss_procc.py:
        985-1085). On a grid (`xtest` given): one joint path and its argmax
        (`sample_and_max`). Without one: from `multistart` uniform starts in
        the bounds (self.bounds, else ±diameter), a coordinate sweep that
        draws the path on a `grid`-point line through the current point
        along each axis, conditions the GP on that fantasised line and
        moves to its argmax; the best start's point and value are returned
        and the data restored. Draws come from `generator` (torch's default
        generator where None): a start's uniforms, then each line's path."""
        if xtest is not None:
            return self.sample_and_max(xtest, size=1, generator=generator)
        if self.bounds is not None:
            bounds = self._tensor(self.bounds).reshape(self.d, 2)
        else:
            bounds = self._tensor([[-self.diameter, self.diameter]] * self.d)
        where = self.device if generator is None else generator.device
        xold, yold = self.x, self.y
        results = []
        try:
            for _ in range(multistart):
                u = torch.rand((self.d,), generator=generator,
                               dtype=self.dtype, device=where).to(self.device)
                solution = bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])
                last_val = None
                for i in range(self.d):
                    line = solution[None, :].repeat(grid, 1)
                    line[:, i] = torch.linspace(float(bounds[i, 0]),
                                                float(bounds[i, 1]), grid,
                                                dtype=self.dtype,
                                                device=self.device)
                    fsample = self.sample(line, size=1, generator=generator)
                    # condition on the fantasised line (gauss_procc.py:
                    # 1050-1056)
                    self.fit_gp(torch.cat([self.x, line]),
                                torch.cat([self.y, fsample]))
                    idx = int(torch.argmax(fsample[:, 0]))
                    solution = solution.clone()
                    solution[i] = line[idx, i]
                    last_val = fsample[idx, 0]
                results.append((solution, last_val))
                self.fit_gp(xold, yold)
        finally:
            self.fit_gp(xold, yold)
        best = int(np.argmax([float(v) for _, v in results]))
        sol, val = results[best]
        return sol[None, :], val

    # -- evidence ---------------------------------------------------------------
    def log_marginal(self, kernel, X, weight=1.0):
        """The negative log evidence: Gaussian for the squared loss
        (`log_marginal_params`), the MAP/Laplace evidence for a robust one
        (`_log_marginal_map`)."""
        if self.loss == "squared":
            return self.log_marginal_params(kernel, X, self.s, weight)
        return self._log_marginal_map(kernel, X, weight)

    def _log_marginal_map(self, kernel, X, weight):
        """MAP/Laplace evidence of a robust loss by Danskin's theorem
        (gauss_procc.py:579-627): ½·obj(α̂) + ½·weight·log det H, with α̂ the
        inner argmin (L-BFGS, zoom, 300 iterations) held fixed and H the
        Hessian of the objective in alpha at α̂ (+1e-8 I), so the gradient
        flows through K(X) into the Gram Functions' backward only. H is
        formed by `torch.autograd.functional.hessian` in alpha with K a
        fixed tensor of the graph, so the Gram Function is not re-entered
        inside it. As `log_marginal_params`, it runs in float64 on the
        model's Gram (K + 1e-4 I)."""
        f64 = torch.float64
        n = self.x.shape[0]
        K = kernel.eval_params(X, self.x, self.x).to(f64)
        K = 0.5 * (K + K.T) + 1e-4 * torch.eye(n, dtype=f64, device=K.device)
        y = self.y.to(f64)
        inner = self._loss_objective(K.detach(), y)
        alpha = minimize_lbfgs(inner, torch.zeros(n, dtype=f64,
                                                  device=K.device),
                               max_iter=300).x.detach()
        obj = self._loss_objective(K, y)
        H = torch.autograd.functional.hessian(obj, alpha, create_graph=True,
                                              vectorize=True)
        H = H + 1e-8 * torch.eye(n, dtype=f64, device=K.device)
        logdet = -0.5 * torch.linalg.slogdet(H)[1] * weight
        return -(-0.5 * obj(alpha) + logdet)

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
        evidence by `optimize_params_general`, the group structure of its
        additive atoms (`"groups"`: every partition of the d coordinates)
        or a full-covariance atom's `cov` (`"covariance"`, `"rots"`:
        `_optimize_cov_manifold`, `restarts` starts from `generator`),
        then refit.
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
            # the full-covariance kernel's `cov` on the PSD manifold
            # (covariance) or the Stiefel manifold (rots)
            return self._optimize_cov_manifold(
                type, restarts=restarts, maxiter=maxiter, weight=weight,
                generator=generator)
        elif type == "groups":
            optimizer = "discrete"
            d = self.kernel_object.d
            for pkey in pdict:
                if self.kernel_object._atoms[int(pkey)].static.get("groups"):
                    params[pkey] = {"groups": (None, generate_groups(d), None)}
        else:
            raise AttributeError("This quick-optimization is not implemented.")

        return self.optimize_params_general(
            params=params, restarts=restarts, optimizer=optimizer,
            regularizer_func=regularizer_func, maxiter=maxiter,
            mingradnorm=mingradnorm, verbose=verbose, scale=scale,
            weight=weight, save=save, save_name=save_name,
            generator=generator, **hyperopt_kwargs,
        )

    def _optimize_cov_manifold(self, type, restarts=4, maxiter=200,
                               weight=1.0, generator=None):
        """Fit the full-covariance kernel's `cov` on the evidence over the
        PSD manifold (type='covariance': L-BFGS on the factor of A = Y Yᵀ)
        or the Stiefel manifold (type='rots': projected gradient steps with
        QR retraction), then refit. `generator` draws the restarts'
        starts."""
        kernel = self.kernel_object
        target_key = None
        for pkey, d2 in kernel.params_dict.items():
            if "cov" in d2:
                target_key = pkey
        if target_key is None:
            raise AttributeError(
                "No `cov` kernel parameter to optimize (use a "
                "full_covariance_* kernel).")
        d = kernel.params_dict[target_key]["cov"].shape[0]

        def objective(C):
            return self.log_marginal_params(
                kernel, {target_key: {"cov": C}}, self.s, weight)

        if type == "covariance":
            C_opt, _ = optimize_psd(objective, d, restarts=restarts,
                                    generator=generator, max_iter=maxiter,
                                    device=self.device)
        else:
            C_opt, _ = optimize_stiefel(objective, d, d, restarts=restarts,
                                        generator=generator, steps=maxiter,
                                        device=self.device)
        kernel.params_dict[target_key]["cov"] = C_opt.detach()
        self.fitted = False
        self.fit_gp(self.x, self.y)
        return True

    # -- BO acquisition (gauss_procc.py:918-1085) ------------------------------
    def _acquisition(self, pts, beta, sign):
        """sign·μ + β·σ of the posterior at each row of `pts` (m, d), on the
        stored factor and alpha: the cross Gram by the Gram kernel, through
        `_Gram` where `pts` needs a gradient."""
        ko, pd = self.kernel_object, self.kernel_object.params_dict
        K_star = ko.eval_params(pd, pts, self.x)                  # (m, n)
        mu = (K_star @ self.A)[:, 0]
        V = tri_solve(self.L, K_star.T)
        var = torch.clamp(ko.diag(pts, pd) - torch.sum(V * V, dim=0),
                          min=1e-30)
        return sign * mu + beta * torch.sqrt(var)

    def ucb_optimize(self, beta=2.0, multistart=25, lcb=False, generator=None,
                     steps=200, lr=0.05):
        """Maximise μ ± β·σ over self.bounds by projected gradient ascent
        (step `lr`, `steps` steps) from `multistart` uniform starts drawn
        from `generator` (default: a fresh one seeded 7, the JAX package's
        PRNGKey(7)). The starts ascend together as one (multistart, d)
        tensor: a start's acquisition depends on its own row only, so one
        backward of their sum gives every row its gradient. Returns the best
        point (d,) and its value μ ± β·σ."""
        assert self.bounds is not None, "ucb_optimize needs box bounds"
        bounds = self._tensor(self.bounds).reshape(self.d, 2)
        lo, hi = bounds[:, 0], bounds[:, 1]
        sign = -1.0 if lcb else 1.0
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(7)
        u = torch.rand((multistart, self.d), generator=generator,
                       dtype=self.dtype,
                       device=generator.device).to(self.device)
        pts = lo + u * (hi - lo)
        for _ in range(steps):
            with torch.enable_grad():
                p = pts.detach().requires_grad_()
                (g,) = torch.autograd.grad(
                    self._acquisition(p, beta, sign).sum(), p)
            pts = torch.clamp(pts + lr * g, lo, hi)
        with torch.no_grad():
            vals = self._acquisition(pts, beta, sign)
        best = int(torch.argmax(vals))
        return pts[best], sign * vals[best]

    # -- the adversarially robust "volume" mean (gauss_procc.py:710-896) --------
    def volume_mean(self, xtest, weights=None, eps=1e-1, tol=1e-6,
                    max_iter=1000, verbose=False, scale=None, slope=1.0,
                    relax="relu", B="auto", bisections=10,
                    optimize_scale=False):
        """Adversarially robust mean: the least-RKHS-norm function β that
        stays within an ε-band of as much (weighted) data as it can,

            min_β Σ_i w_i ρ(slope·(|β_i − y_i| − ε)) + (scale/2)·βᵀK⁻¹β,

        with ρ = relu (its exact elementwise prox, FISTA with backtracking)
        or the logistic (smooth; L-BFGS with the zoom line search), and
        `scale` set by bisection so that βᵀK⁻¹β meets the budget B (by
        default the squared-loss fit's).

        It runs in float64 whatever the model's dtype, on `_gram64`'s Gram
        (the double-float Gram on a narrower model): βᵀ(K + 1e-6 I)⁻¹β has
        the condition number of K + 1e-6 I (6e8 on `benchmarks/run_all.py`
        config 1), so an f32 Gram's rounding (~6e-8 relative) leaves
        nothing of it, and an f32 run ends elsewhere (its bisection at the
        top of the bracket on config 1, the CPU's f32). Returns the model's
        dtype."""
        f64 = torch.float64
        xtest = self._tensor(xtest)
        n = self.n
        K = self._gram64(self.x, self.x)
        K = 0.5 * (K + K.T) + 1e-6 * torch.eye(n, dtype=f64,
                                               device=self.device)
        L = safe_cholesky(K).L
        yv = self.y.reshape(-1).to(f64)
        w = (torch.ones(n, dtype=f64, device=self.device) / n
             if weights is None else self._tensor(weights).reshape(-1).to(f64))

        def quad(beta):
            return beta @ cho_solve(L, beta.reshape(-1, 1)).reshape(-1)

        if B == "auto":
            B = float(quad((K @ cho_solve(L, self.y.to(f64))).reshape(-1)))

        def fit_beta(scale_arg):
            if relax == "relu":
                def smooth(beta):
                    return 0.5 * scale_arg * quad(beta)

                def prox(beta, step):
                    # the prox of step·w·slope·relu(|t − y| − ε): a shrink
                    # toward the ε-band, exact and elementwise
                    r = beta - yv
                    excess = torch.clamp(torch.abs(r) - eps, min=0.0)
                    shrink = torch.minimum(step * w * slope, excess)
                    return beta - torch.sign(r) * shrink

                return fista_prox_backtracking(smooth, yv, prox,
                                               max_iter=max_iter, tol=tol).x

            def obj(beta):
                t = slope * (torch.abs(beta - yv) - eps)
                return torch.sum(w * _softplus(t)) + 0.5 * scale_arg * quad(
                    beta)

            return minimize_lbfgs(obj, yv, max_iter=max_iter).x

        if scale is None or optimize_scale:
            def gap(s_arg):
                return quad(fit_beta(torch.clamp(s_arg, min=1e-8))) - B

            one = torch.ones((), dtype=f64, device=self.device)
            scale = float(bisection(gap, 1e-6 * one, one, iters=bisections))
            if optimize_scale:
                return scale
        alpha = cho_solve(L, fit_beta(scale).reshape(-1, 1))
        return (self._gram64(xtest, self.x) @ alpha).to(self.dtype)

    volume_mean_cvxpy = volume_mean   # the reference's name (its cvxpy path)

    def volume_mean_norm(self, xtest, **kwargs):
        """`volume_mean` with the weights normalised to sum 1."""
        w = kwargs.pop("weights", None)
        if w is not None:
            w = self._tensor(w).reshape(-1)
            w = w / torch.clamp(torch.sum(w), min=1e-12)
        return self.volume_mean(xtest, weights=w, **kwargs)

    def isin(self, xnext, epsilon=1e-3):
        """Whether `xnext` lies within `epsilon` (L2) of a training point."""
        if self.x is None:
            return False
        xnext = self._tensor(xnext).reshape(1, -1)
        return bool(torch.any(
            torch.linalg.vector_norm(self.x - xnext, dim=1) < epsilon))

    # -- posterior derivatives in the point (gauss_procc.py:416-459) ------------
    def _pointwise_posterior_fns(self):
        """The posterior mean and variance at one point (d,), differentiable
        in it: on the stored f32 factor and alpha (hi column), the cross
        Gram through `_Gram`, whose backward is itself differentiable, so
        second derivatives are reverse over reverse, as in the JAX
        package (the df Gram has no derivative there either)."""
        ko, pd, A = self.kernel_object, self.kernel_object.params_dict, self.A

        def mu_fn(pt):
            return (ko.eval_params(pd, pt[None, :], self.x) @ A)[0, 0]

        def var_fn(pt):
            K_star = ko.eval_params(pd, pt[None, :], self.x)
            v = tri_solve(self.L, K_star.T)
            return ko.diag(pt[None, :], pd)[0] - torch.sum(v * v)

        return mu_fn, var_fn

    @staticmethod
    def _grad_and_hessian(fn, point, hessian):
        """∇fn at `point` and, with `hessian`, its Hessian (reverse over
        reverse, one row per coordinate)."""
        with torch.enable_grad():
            p = point.detach().requires_grad_()
            (g,) = torch.autograd.grad(fn(p), p, create_graph=hessian)
            if not hessian:
                return g
            H = torch.stack([torch.autograd.grad(g[i], p, retain_graph=True)[0]
                             for i in range(p.shape[0])])
        return g.detach(), H

    def gradient_mean_var(self, point, hessian=True):
        """∇μ at one point and, with `hessian`, the Hessian of the posterior
        variance there: [∇μ, ∇²σ²]."""
        point = self._tensor(point).reshape(-1)
        mu_fn, var_fn = self._pointwise_posterior_fns()
        nabla_mu = self._grad_and_hessian(mu_fn, point, False)
        if not hessian:
            return nabla_mu
        return [nabla_mu, self._grad_and_hessian(var_fn, point, True)[1]]

    def mean_gradient_hessian(self, xtest, hessian=False):
        """∇μ at one point and, with `hessian`, [∇μ, ∇²μ]."""
        xtest = self._tensor(xtest).reshape(-1)
        mu_fn, _ = self._pointwise_posterior_fns()
        if not hessian:
            return self._grad_and_hessian(mu_fn, xtest, False)
        return list(self._grad_and_hessian(mu_fn, xtest, True))
