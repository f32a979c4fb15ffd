"""PoissonRateEstimator: a positive-basis rate λ(x) = Φ(x)ᵀθ with box
constraints, MAP fits, and the UCB/LCB confidence machinery.

Port of stpy_tpu/point_processes/poisson_rate_estimator.py: the basis
selector, the dual/anchor approximation, the per-basic-set integrals
`varphis`, every MAP route of `fit_gp` (count-record and histogram
feedback with the `likelihood`, `least-sq` and `bins` estimators, and the
anchor solve), the Laplace/regression/bins covariances, the per-action
ellipsoid-slice bounds (`ucb_lcb_actions` bounds a stack of actions in one
batched solve, `opt/ellipsoid.py`), the likelihood-ratio bounds, the
experiment-design acquisitions, the conformal sets and the posterior
samplers (every `sampling=` route, on inference/langevin.py and
inference/hmc.py). The estimator takes an explicit ``device`` (None: the
card) and ``dtype``; its random draws (the samplers' noise, the conformal
sets' synthetic points) come from a `torch.Generator` seeded with 23 on
that device, where the JAX package holds PRNGKey(23).

Every MAP fit is a box L-BFGS in the w = Γ^{1/2}θ variable through a
sigmoid reparameterisation, on the port's `opt/lbfgs.minimize_lbfgs`. The
JAX package jits each solver at module level with the data as arguments;
here they are plain functions of tensors. The box objectives carry a
curvature of about 1e12, so the solves run to `map_max_iter`, and their
iterates are chaotic in the last digits: compare fits by objective values
and totals. The L-BFGS reads its stop test on the host every iteration.
`jit_pad` is accepted and does nothing (rate_estimator.py).
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import resolve_device
from stpy_tpu_torch.embeddings.bernstein import (
    BernsteinEmbedding,
    BernsteinSplinesEmbedding,
    BernsteinSplinesOverlapping,
)
from stpy_tpu_torch.embeddings.nystrom import PositiveNystromEmbeddingBump
from stpy_tpu_torch.embeddings.positive import (
    FaberSchauderEmbedding,
    TriangleEmbedding,
)
from stpy_tpu_torch.inference.hmc import hmc_sample
from stpy_tpu_torch.inference.langevin import (
    mirror_langevin_box,
    mirror_langevin_positive,
    mla_prime_positive,
    newton_langevin,
    projected_langevin,
    proximal_langevin,
)
from stpy_tpu_torch.opt.ellipsoid import maximize_on_elliptical_slice
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.opt.prox import fista_backtracking
from stpy_tpu_torch.point_processes.rate_estimator import RateEstimator

def jnp_pinv(A):
    """Pseudo-inverse with jax.numpy's default cut, 10·max(m, n)·eps."""
    return torch.linalg.pinv(
        A, rtol=10.0 * max(A.shape) * torch.finfo(A.dtype).eps)


def _box_map(l, u, w0, eps=1e-4):
    """(l + eps, span, z0) of the sigmoid box map w = l + eps + span·σ(z):
    z0 the logit of w0's place in the box, clipped to [1e-4, 1 − 1e-4]."""
    l_arr = l + eps
    span = u - l_arr
    t0 = torch.clamp((w0 - l_arr) / span, 1e-4, 1 - 1e-4)
    return l_arr, span, torch.log(t0) - torch.log1p(-t0)


def map_count_record_lbfgs(phis, observations, mult, invG_half, s, l, u, w0,
                           max_iter=3000, G_half=None, warm=False):
    """The count-record MAP solve: −Σ c_i log(o_iᵀθ) + Σ_r φ_rᵀθ +
    s/2‖θ‖² over the box in w, by L-BFGS with the batched line search,
    xtol 1e-8 and the step clip 9.21 (logit(1 − 1e-4)). With warm=True,
    w0 is the previous rate and goes through G_half first. Returns
    (w*, θ* = Γ^{-1/2}w*)."""
    if warm:
        w0 = G_half @ w0
    phis_raw = phis @ invG_half
    obs_raw = observations @ invG_half
    l_arr, span, z0 = _box_map(l, u, w0)

    def obj(z):
        w = l_arr + span * torch.sigmoid(z)
        lam = torch.clamp(obs_raw @ w, min=1e-12)
        reg = invG_half @ w
        return (-torch.sum(mult * torch.log(lam)) + torch.sum(phis_raw @ w)
                + 0.5 * s * torch.sum(reg * reg))

    res = minimize_lbfgs(obj, z0, max_iter=max_iter, tol=1e-9,
                         memory_size=30, xtol=1e-8, linesearch="batched",
                         step_clip=9.21)
    w_star = l_arr + span * torch.sigmoid(res.x)
    return w_star, invG_half @ w_star


def sigmoid_box_lbfgs(obj_w, l, u, w0, max_iter):
    """The bucket solvers' box L-BFGS: the zoom line search, memory 30."""
    l_arr, span, z0 = _box_map(l, u, w0)
    res = minimize_lbfgs(lambda z: obj_w(l_arr + span * torch.sigmoid(z)),
                         z0, max_iter=max_iter, tol=1e-9, memory_size=30)
    return l_arr + span * torch.sigmoid(res.x)


def map_bins_lbfgs(phis_raw, tau, obs, mask, invG_half, s, l, u, w0,
                   max_iter=3000):
    """Binned count-record MAP over every bucket; unvisited ones (τ = obs =
    0) are masked out of the log term."""

    def obj(w):
        lam = torch.clamp(tau * (phis_raw @ w), min=1e-12)
        reg = invG_half @ w
        return (-torch.sum(torch.where(mask, obs * torch.log(lam),
                                       torch.zeros_like(lam)))
                + torch.sum(tau * (phis_raw @ w))
                + 0.5 * s * torch.sum(reg * reg))

    return sigmoid_box_lbfgs(obj, l, u, w0, max_iter)


def map_anchor_lbfgs(phis_raw, tau, obs_raw, weights, invG_half, s, l, u, w0,
                     max_iter=3000):
    """Dual/anchor-compressed MAP; zero-weight anchors are masked out."""

    def obj(w):
        lam = torch.clamp(obs_raw @ w, min=1e-12)
        reg = invG_half @ w
        return (-torch.sum(torch.where(weights > 0, weights * torch.log(lam),
                                       torch.zeros_like(lam)))
                + torch.sum(tau * (phis_raw @ w))
                + 0.5 * s * torch.sum(reg * reg))

    return sigmoid_box_lbfgs(obj, l, u, w0, max_iter)


def wls_bins_lbfgs(phis_raw, tau, obs, var, invG_half, s, l, u, w0,
                   max_iter=3000):
    """Weighted least squares over every bucket; unvisited buckets give
    zero residuals (the caller sets their variance to 1)."""

    def obj(w):
        r = (tau * (phis_raw @ w) - obs) / torch.sqrt(var)
        reg = invG_half @ w
        return torch.sum(r * r) + 0.5 * s * torch.sum(reg * reg)

    return sigmoid_box_lbfgs(obj, l, u, w0, max_iter)


def batched_slice_bounds(phis, W, rate, beta, l, LG, u):
    """(map, ucb, lcb) for a stack of action functionals (A, m): one
    batched ellipsoid-slice solve of the 2A functionals ±φ."""
    A = phis.shape[0]
    vals, _ = maximize_on_elliptical_slice(torch.cat([phis, -phis]), W, rate,
                                           beta, l, LG, u)
    return phis @ rate, vals[:A], -vals[A:]


class PoissonRateEstimator(RateEstimator):
    def __init__(
        self, process, hierarchy, d=1, m=100, kernel_object=None, B=1.0,
        s=1.0, jitter=1e-7, b=0.0, basis="triangle", estimator="likelihood",
        feedback="count-record", offset=0.1, uncertainty="laplace",
        approx=None, stepsize=None, embedding=None, beta=2.0,
        sampling="proximal+prox", peeking=True, constraints=True,
        var_cor_on=True, samples_nystrom=15000, inverted_constraint=False,
        steps=None, dual=False, no_anchor_points=1024, U=1.0, opt="torch",
        generator=None, jit_pad=True, map_max_iter=3000, device=None,
        dtype=torch.float32,
    ):
        # map_max_iter: the iteration cap of the MAP L-BFGS solves, which
        # run to it on these ~1e12-curvature objectives: the wall knob
        self.device, self.dtype = resolve_device(device), dtype
        self.process = process
        self.d = d
        self.s = s
        self.b = b
        self.B = B
        self.U = U
        self.stepsize = stepsize
        self.sampling = sampling
        self.steps = steps
        self.opt = opt
        self.kernel_object = kernel_object
        self.constraints = constraints
        self.hierarchy = hierarchy
        self.ucb_identified = False
        self.inverted_constraint = inverted_constraint
        self.loglikelihood = 0.0
        self.dual = dual
        self.jit_pad = jit_pad
        self.map_max_iter = int(map_max_iter)
        self.peeking = peeking
        self.no_anchor_points = no_anchor_points
        self.var_cor_on = var_cor_on
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(23))
        if beta < 0.0:
            self.beta = lambda t: self.beta_theory()
        else:
            self.beta = lambda t: beta

        emb_kwargs = dict(kernel_object=kernel_object, B=B, b=b, offset=offset,
                          s=np.sqrt(jitter), device=self.device, dtype=dtype)
        if basis == "triangle":
            self.packing = TriangleEmbedding(d, m, **emb_kwargs)
        elif basis == "bernstein":
            self.packing = BernsteinEmbedding(d, m, **emb_kwargs)
        elif basis == "splines":
            self.packing = BernsteinSplinesEmbedding(d, m, **emb_kwargs)
        elif basis == "overlap-splines":
            self.packing = BernsteinSplinesOverlapping(d, m, **emb_kwargs)
        elif basis == "faber":
            self.packing = FaberSchauderEmbedding(d, m, **emb_kwargs)
        elif basis in ("nystrom", "optimal-positive"):
            self.packing = PositiveNystromEmbeddingBump(
                d, m, samples=samples_nystrom, **emb_kwargs)
        elif basis == "custom":
            self.packing = embedding
        else:
            raise NotImplementedError(
                "The request positive basis is not implemented.")
        self.m = m
        self.data = None
        self.covariance = False
        self.jitter = jitter
        self.stabilization = None
        self.approx_fit = False
        self.estimator = estimator
        self.feedback = feedback
        self.uncertainty = uncertainty
        self.approx = approx

        self.basic_sets = self.hierarchy.get_sets_level(self.hierarchy.levels)
        n_basic = len(self.basic_sets)
        mm = self.get_m()
        self.varphis = torch.zeros((n_basic, mm), dtype=dtype, device=self.device)
        self.variances = torch.ones((n_basic,), dtype=dtype, device=self.device)
        self.variances_histogram = []
        self.observations = None
        self.obs_multiplicities = None
        self.rate = None
        eye = torch.eye(mm, dtype=dtype, device=self.device)
        self.W = s * eye
        self.W_inv_approx = (1.0 / s) * eye
        self.beta_value = 2.0
        self.sampled_theta = None

        if self.dual:
            top = self.hierarchy.top_node
            self.anchor_points = top.return_discretization(
                no_anchor_points if self.d == 1
                else int(np.sqrt(no_anchor_points))).to(self.device, dtype)
            self.anchor_weights = torch.zeros((self.anchor_points.shape[0],),
                                              dtype=dtype, device=self.device)
            self.global_dt = 0.0
            self.anchor_points_emb = self.packing.embed(self.anchor_points)

        if feedback == "count-record" and basis != "custom":
            self.varphis = torch.stack(
                [self.packing.integral(S) for S in self.basic_sets], dim=0)
            self.variances = self._tensor(
                [S.volume() * self.B for S in self.basic_sets])

    # -- constraints / covariance of the basis -----------------------------------
    def get_constraints(self):
        # the box (l, Λ, u) depends only on (b, B, m)
        if getattr(self, "_constraints_cache", None) is None:
            self._constraints_cache = self.packing.get_constraints()
        return self._constraints_cache

    def cov(self, inverse=False):
        return self.packing.cov(inverse=inverse)

    def _var_hist_padded(self):
        """Per-round histogram variances (Bernstein-corrected), padded with
        1.0 to the round count: unit variance keeps a round without a
        variance at zero weight."""
        v = np.asarray([float(x) * float(self.variance_correction(float(x)))
                        for x in np.asarray(self.variances_histogram)])
        r = int(self.counts.shape[0])
        if v.shape[0] < r:
            v = np.concatenate([v, np.ones(r - v.shape[0])])
        return self._tensor(v)

    def _start(self, G_half):
        w0 = self._warm_start_w(G_half)
        if w0 is None:
            w0 = torch.full((self.get_m(),), 0.1, dtype=self.dtype,
                            device=self.device)
        return w0

    # -- running likelihood (for the likelihood-ratio sets) ----------------------
    def add_data_point(self, new_data, times=True):
        super().add_data_point(new_data, times=times)
        if self.rate is not None:
            rate = self.rate.reshape(-1, 1)
        else:
            l, _, u = self.get_constraints()
            G_half, invG_half = self.cov(inverse=True)
            rate = (invG_half @ u).reshape(-1, 1)
        S, obs, dt = new_data
        if self.feedback == "histogram":
            val = (self.packing.integral(S) @ rate)[0] * dt
            v = -torch.log(val) + val
        else:
            v = (self.packing.integral(S) @ rate)[0] * dt
            if obs is not None:
                val2 = self.packing.embed(obs) @ rate * dt
                v = v - torch.sum(torch.log(torch.clamp(val2, min=1e-30)))
        self.loglikelihood = self.loglikelihood + float(v)

    # -- bucketization -------------------------------------------------------------
    def bucketization(self):
        """Counts, times and per-round observation counts of every basic
        set, over the rounds that cover it."""
        nb = len(self.basic_sets)
        data_counts = [[] for _ in range(nb)]
        sensing_times = [[] for _ in range(nb)]
        counts = np.zeros(nb, dtype=np.int32)
        tot_obs = np.zeros(nb)
        tot_time = np.zeros(nb)
        for S, obs, dt in self.data:
            idx = self._contained_leaves(S)
            if not idx:
                continue
            c = (self._leaf_obs_counts(idx, self._tensor(obs))
                 if obs is not None else np.zeros(len(idx)))
            for i, ci in zip(idx, c):
                data_counts[i].append(float(ci))
                sensing_times[i].append(dt)
            counts[idx] += 1
            tot_obs[idx] += c
            tot_time[idx] += dt
        self.bucketized_obs = [np.asarray(c) for c in data_counts]
        self.bucketized_time = sensing_times
        self.bucketized_counts = torch.as_tensor(counts, device=self.device)
        self.total_bucketized_obs = self._tensor(tot_obs)
        self.total_bucketized_time = self._tensor(tot_time)

    # -- Bernstein variance correction ------------------------------------------------
    def variance_correction(self, variance):
        """The root k ∈ [1, 1e7] of the Bernstein correction by 60
        bisection steps on the host; 1 where there is no sign change."""
        if not self.var_cor_on:
            return 1.0
        v = float(variance)
        U = self.U

        def g(k):
            return (-0.5 * U**2 / (v**2 * k) - U / (v * k)
                    + (np.exp(U / (k * v)) - 1.0))

        lo, hi = 1.0, 1e7
        if g(lo) * g(hi) > 0:
            return 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if g(lo) * g(mid) <= 0:
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)

    # -- MAP fits ------------------------------------------------------------------
    def _box_solve(self, objective, l, u, w0=None, eps=1e-4, max_iter=None):
        """Box-constrained minimisation through the sigmoid map and L-BFGS
        (the zoom line search, memory 30). First-order projected methods
        stall here: the s/2‖Γ^{-1/2}w‖² term has a curvature up to the
        squared condition number of the kernel Gram."""
        if w0 is None:
            w0 = torch.full((self.get_m(),), 0.1, dtype=self.dtype,
                            device=self.device)
        l_arr, span, z0 = _box_map(l, u, w0, eps)
        if max_iter is None:
            max_iter = self.map_max_iter
        res = minimize_lbfgs(lambda z: objective(l_arr + span * torch.sigmoid(z)),
                             z0, max_iter=max_iter, tol=1e-9, memory_size=30)
        return l_arr + span * torch.sigmoid(res.x)

    def _warm_start_w(self, G_half):
        if self.rate is None:
            return None
        return G_half @ self.rate.reshape(-1)

    def penalized_likelihood_fast(self, threads=4):
        """Count-record penalized MAP: −Σ c_i log(o_iᵀθ) + Σ_r τ_r φ_rᵀθ +
        s/2‖Γ^{-1/2}w‖² over the box in w."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)

        if not self.dual:
            if self.observations is not None:
                warm = self.rate is not None
                w0 = (self.rate.reshape(-1) if warm else
                      torch.full((self.get_m(),), 0.1, dtype=self.dtype,
                                 device=self.device))
                _, self.rate = map_count_record_lbfgs(
                    self.phis, self.observations, self.obs_multiplicities,
                    invG_half, self.s, l, u, w0, max_iter=self.map_max_iter,
                    G_half=G_half, warm=warm)
                return self.rate
            phis_raw = self.phis @ invG_half

            def objective(w):
                reg = invG_half @ w
                return torch.sum(phis_raw @ w) + 0.5 * self.s * torch.sum(
                    reg * reg)
        else:
            # every bucket (unvisited ones have τ = 0) and the fixed anchors
            phis_raw = self.varphis @ invG_half
            tau = self.total_bucketized_time
            if self.observations is not None:
                w_star = map_anchor_lbfgs(
                    phis_raw, tau, self.anchor_points_emb @ invG_half,
                    self.anchor_weights, invG_half, self.s, l, u,
                    self._start(G_half), max_iter=self.map_max_iter)
                self.rate = invG_half @ w_star
                return self.rate

            def objective(w):
                reg = invG_half @ w
                return torch.sum(tau * (phis_raw @ w)) + 0.5 * self.s * (reg @ reg)

        w_star = self._box_solve(objective, l, u, self._warm_start_w(G_half))
        self.rate = invG_half @ w_star
        return self.rate

    def penalized_likelihood(self, threads=4):
        return self.penalized_likelihood_fast(threads=threads)

    def penalized_likelihood_integral(self, threads=4):
        """Histogram-feedback MAP: −Σ c_r log(φ_rᵀθ) + Σ φ_rᵀθ + s/2‖ξ‖²."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        phis_raw = self.phis @ invG_half
        counts = self.counts

        def objective(w):
            lam = torch.clamp(phis_raw @ w, min=1e-12)
            reg = invG_half @ w
            return (-torch.sum(counts * torch.log(lam)) + torch.sum(phis_raw @ w)
                    + 0.5 * self.s * torch.sum(reg * reg))

        w_star = self._box_solve(objective, l, u, self._warm_start_w(G_half))
        self.rate = invG_half @ w_star
        return self.rate

    def penalized_likelihood_bins(self, threads=4):
        """Binned count-record MAP."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        w_star = map_bins_lbfgs(
            self.varphis @ invG_half, self.total_bucketized_time,
            self.total_bucketized_obs, self.bucketized_counts > 0, invG_half,
            self.s, l, u, self._start(G_half), max_iter=self.map_max_iter)
        self.rate = invG_half @ w_star
        return self.rate

    def penalized_likelihood_integral_bins(self, threads=4):
        return self.penalized_likelihood_integral(threads=threads)

    def _bucket_variances(self):
        """Each visited bucket's variance·τ·correction; 1 elsewhere."""
        mask = (self.bucketized_counts > 0).cpu().numpy()
        tau = self.total_bucketized_time.cpu().double().numpy()
        var_in = self.variances.cpu().double().numpy()
        variances = np.ones_like(tau)
        for i in np.nonzero(mask)[0]:
            v = var_in[i] * tau[i]
            variances[i] = v * self.variance_correction(v)
        return variances

    def least_squares_weighted(self, threads=4):
        """Weighted least squares with the Bernstein variance correction."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        w_star = wls_bins_lbfgs(
            self.varphis @ invG_half, self.total_bucketized_time,
            self.total_bucketized_obs, self._tensor(self._bucket_variances()),
            invG_half, self.s, l, u, self._start(G_half),
            max_iter=self.map_max_iter)
        self.rate = invG_half @ w_star
        return self.rate

    least_sqaures_weighted_fast = least_squares_weighted  # the reference's name

    def least_squares_weighted_integral(self, threads=4):
        """Histogram weighted least squares."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        phis_raw = self.phis @ invG_half
        if len(self.variances_histogram) > 0:
            var = self._var_hist_padded()
        else:
            var = self._tensor([
                S.volume() * self.B * self.variance_correction(
                    S.volume() * self.B) for S, _, _ in self.data])
        counts = self.counts
        if var.shape[0] < counts.shape[0]:
            var = torch.cat([var, torch.ones(counts.shape[0] - var.shape[0],
                                             dtype=var.dtype, device=var.device)])

        def objective(w):
            r = (phis_raw @ w - counts) / torch.sqrt(var)
            reg = invG_half @ w
            return torch.sum(r * r) + self.s * torch.sum(reg * reg)

        w_star = self._box_solve(objective, l, u, self._warm_start_w(G_half))
        self.rate = invG_half @ w_star
        return self.rate

    def fit_gp(self, threads=4):
        """Fit dispatch on (feedback, estimator)."""
        if self.data is None:
            self.rate = None
            return
        routes = {
            "count-record": {"likelihood": self.penalized_likelihood_fast,
                             "least-sq": self.least_squares_weighted,
                             "bins": self.penalized_likelihood_bins},
            "histogram": {"likelihood": self.penalized_likelihood_integral,
                          "least-sq": self.least_squares_weighted_integral,
                          "bins": self.penalized_likelihood_integral_bins},
        }
        if self.feedback not in routes or self.estimator not in routes[self.feedback]:
            raise AssertionError("wrong name.")
        routes[self.feedback][self.estimator](threads)

    fit = fit_gp

    # -- confidence machinery ----------------------------------------------------
    def beta_theory(self):
        if not self.approx_fit:
            l, Lambda, u = self.get_constraints()
            G_half, invG_half = self.cov(inverse=True)
            res = G_half @ self.rate.reshape(-1, 1) - l.reshape(-1, 1)
            xi = torch.where(res > 1e-2, torch.zeros_like(res), res)
            constraint = (xi.T @ G_half @ self.W_inv_approx @ G_half.T @ xi)[0, 0]
            _, logdet = torch.linalg.slogdet(self.W)
            vol = 4 * np.log(1.0 / 0.1) + logdet - self.get_m() * np.log(self.s)
            self.beta_value = float(torch.sqrt(self.s + vol + constraint))
        return self.beta_value

    def construct_covariance_matrix(self):
        builders = {"likelihood": self.construct_covariance_matrix_laplace,
                    "least-sq": self.construct_covariance_matrix_regression,
                    "bins": self.construct_covariance_matrix_bins}
        if self.estimator not in builders:
            raise NotImplementedError("This estimator is not implemented.")
        self.W = builders[self.estimator]()
        return self.W

    def _plus_s(self, W):
        return W + torch.eye(W.shape[0], dtype=W.dtype, device=W.device) * self.s

    def _zeros_mm(self):
        mm = self.get_m()
        return torch.zeros((mm, mm), dtype=self.dtype, device=self.device)

    def construct_covariance_matrix_laplace(self, theta=None):
        """W = Φ_obsᵀ D Φ_obs + s·I, D = diag(c_i/λ(x_i)²)."""
        W = self._zeros_mm()
        if self.feedback == "count-record":
            if self.observations is not None:
                th = self.rate if theta is None else theta
                lam = torch.clamp((self.observations @ th.reshape(-1, 1)).ravel(),
                                  min=1e-10)
                Dw = self.obs_multiplicities / lam**2
                W = (self.observations * Dw[:, None]).T @ self.observations
        elif self.feedback == "histogram":
            if len(self.variances_histogram) > 0:
                Dw = self.counts / self._var_hist_padded() ** 2
                W = (self.phis * Dw[:, None]).T @ self.phis
        else:
            raise AssertionError("Not implemented.")
        return self._plus_s(W)

    def _visited_inverse_variances(self):
        """τ_i/v_i on the visited buckets, 0 elsewhere (in float64, on the
        device): the count-record weights without the variance correction,
        as the log-linear and MBR covariances take them."""
        tau = self.total_bucketized_time.double()
        var = self.variances.double()
        Dw = torch.where(self.bucketized_counts > 0, tau / var,
                         torch.zeros_like(tau))
        return Dw.to(self.dtype)

    def _visited_weights(self):
        """τ_i/(v_i·k_i) on the visited buckets, 0 elsewhere: v_i the
        bucket's variance and k_i its correction at v_i·τ_i."""
        mask = (self.bucketized_counts > 0).cpu().numpy()
        tau = self.total_bucketized_time.cpu().double().numpy()
        var = self.variances.cpu().double().numpy()
        Dw = np.zeros_like(tau)
        for i in np.nonzero(mask)[0]:
            Dw[i] = tau[i] / (var[i] * self.variance_correction(tau[i] * var[i]))
        return self._tensor(Dw)

    def construct_covariance_matrix_regression(self):
        """W = Σ over visited buckets of τ_i φ_i φ_iᵀ/(v_i k_i) + s·I."""
        W = self._zeros_mm()
        if self.data is not None and self.feedback == "count-record":
            Dw = self._visited_weights()
            W = (self.varphis * Dw[:, None]).T @ self.varphis
        elif self.feedback == "histogram" and len(self.variances_histogram) > 0:
            Dw = 1.0 / self._var_hist_padded()
            W = (self.phis * Dw[:, None]).T @ self.phis
        return self._plus_s(W)

    def construct_covariance_matrix_bins(self):
        """The bins covariance: the regression weights where there are
        observations."""
        W = self._zeros_mm()
        if self.feedback == "count-record":
            if self.observations is not None:
                Dw = self._visited_weights()
                W = (self.varphis * Dw[:, None]).T @ self.varphis
        elif self.feedback == "histogram" and len(self.variances_histogram) > 0:
            Dw = 1.0 / self._var_hist_padded()
            W = (self.phis * Dw[:, None]).T @ self.phis
        else:
            raise AssertionError("Not implemented.")
        return self._plus_s(W)

    def _uncertainty_covariance(self):
        builders = {"laplace": self.construct_covariance_matrix_laplace,
                    "least-sq": self.construct_covariance_matrix_regression,
                    "bins": self.construct_covariance_matrix_bins}
        if self.uncertainty not in builders:
            return None
        return builders[self.uncertainty]()

    def fit_ellipsoid_approx(self):
        W = self._uncertainty_covariance()
        if W is None:
            raise AssertionError("Not implemented.")
        self.W = W
        self.W_inv_approx = jnp_pinv(self.W)

    # -- per-action bounds ---------------------------------------------------------
    def _slice_box(self):
        G_half = self.cov()
        l, Lambda, u = self.get_constraints()
        return l, Lambda @ G_half, u

    def mean_std_per_action(self, S, W, dt, beta):
        """(map, ucb, lcb) of one action by the ellipsoid-slice solve."""
        phi = self.packing.integral(S) * dt
        l, LG, u = self._slice_box()
        rate = self.rate.reshape(-1)
        ucb, _ = maximize_on_elliptical_slice(phi, W, rate, beta, l, LG, u)
        lcb, _ = maximize_on_elliptical_slice(-phi, W, rate, beta, l, LG, u)
        return phi @ self.rate, float(ucb), -float(lcb)

    def ucb_lcb_actions(self, Ss, dt=1.0):
        """(maps, ucbs, lcbs) for a list of actions, by one batched
        ellipsoid-slice solve of every action's ±φ."""
        if self.data is None or self.rate is None:
            vols = self._tensor([float(S.volume()) for S in Ss])
            ub = self.B * vols * dt
            return torch.zeros_like(ub), ub, torch.zeros_like(ub)
        W = self._uncertainty_covariance()
        if W is None:
            raise NotImplementedError(
                "batched bounds support laplace/least-sq/bins uncertainty")
        phis = torch.stack([self.packing.integral(S) for S in Ss]) * dt
        l, LG, u = self._slice_box()
        return batched_slice_bounds(phis, W, self.rate.reshape(-1),
                                    float(self.beta(0)), l, LG, u)

    def _mean_var_set(self, builder, S, dt, beta):
        if not self.approx_fit:
            self.W = builder()
            self.approx_fit = True
        return self.mean_std_per_action(S, self.W, dt, beta)

    def mean_var_laplace_set(self, S, dt, beta=2.0):
        return self._mean_var_set(self.construct_covariance_matrix_laplace,
                                  S, dt, beta)

    def mean_var_reg_set(self, S, dt, beta=2.0):
        return self._mean_var_set(self.construct_covariance_matrix_regression,
                                  S, dt, beta)

    def mean_var_bins_set(self, S, dt, beta=2.0):
        return self._mean_var_set(self.construct_covariance_matrix_bins,
                                  S, dt, beta)

    def _nll_counts(self, invG_half):
        """w ↦ −Σ c_r log(φ_rᵀθ) + Σ φ_rᵀθ + s/2‖Γ^{-1/2}w‖² of the rounds."""
        phis_raw = self.phis @ invG_half
        counts = self.counts

        def nll(w):
            lam = torch.clamp(phis_raw @ w, min=1e-12)
            reg = invG_half @ w
            return (-torch.sum(counts * torch.log(lam)) + torch.sum(phis_raw @ w)
                    + 0.5 * self.s * torch.sum(reg * reg))
        return nll

    def _lr_bounds(self, x, delta, max_iter):
        """(ucb, lcb) of xᵀθ over the likelihood-ratio sublevel set
        nll(w) ≤ log(1/δ) + loglikelihood + s/2‖θ̂‖², each by box FISTA on
        the penalty ±xᵀθ + 10³·max(nll − v, 0)² from θ̂ clipped to the box."""
        v = (np.log(1.0 / delta) + self.loglikelihood
             + 0.5 * self.s * float(torch.linalg.vector_norm(self.rate)) ** 2)
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        nll = self._nll_counts(invG_half)
        x_raw = x @ invG_half
        lo = l + 1e-4
        w0 = G_half @ self.rate.reshape(-1)

        def bound(sign, rho=1e3):
            def obj(w):
                return sign * (x_raw @ w) + rho * torch.clamp(nll(w) - v,
                                                              min=0.0) ** 2

            res = fista_backtracking(obj, torch.clamp(w0, lo, u),
                                     lambda t: torch.clamp(t, lo, u),
                                     max_iter=max_iter)
            return float(x_raw @ res.x)

        return bound(-1.0), bound(+1.0)

    def mean_var_ratio_set(self, S, dt, beta=2.0):
        """Likelihood-ratio bound of one action (δ = 0.1, 500 FISTA
        steps)."""
        x = self.packing.integral(S) * dt
        ucb, lcb = self._lr_bounds(x, 0.1, 500)
        return x @ self.rate, ucb, lcb

    def map_lcb_ucb_approx_action(self, S, dt=1.0, beta=2.0):
        phi = self.packing.integral(S)
        map_ = dt * phi @ self.rate
        width = beta * torch.sqrt(phi @ self.W_inv_approx @ phi)
        return map_, map_ - width, map_ + width

    def _bound(self, S, dt, which, delta=0.5):
        sets = {"laplace": self.mean_var_laplace_set,
                "least-sq": self.mean_var_reg_set,
                "bins": self.mean_var_bins_set,
                "likelihood-ratio": self.mean_var_ratio_set}
        if self.uncertainty in sets:
            return sets[self.uncertainty](S, dt=dt, beta=self.beta(0))[which]
        if which == 1 and self.uncertainty == "conformal":
            return self.mean_var_conformal_set(S, dt=dt, delta=delta)[2]
        raise AssertionError("Not Implemented.")

    def ucb(self, S, dt=1.0, delta=0.5):
        if self.data is None or self.rate is None:
            return self.B * S.volume() * dt
        if self.approx is None:
            return self._bound(S, dt, 1, delta)
        if self.approx == "ellipsoid":
            if not self.approx_fit:
                self.fit_ellipsoid_approx()
                self.beta(0)
                self.approx_fit = True
            return float(self.map_lcb_ucb_approx_action(
                S, dt=dt, beta=self.beta(0))[2])
        raise AssertionError("Not implemented.")

    def lcb(self, S, dt=1.0):
        if self.data is None or self.rate is None:
            return self.b * S.volume() * dt
        if self.approx is None:
            return self._bound(S, dt, 2)
        if self.approx == "ellipsoid":
            if not self.approx_fit:
                self.fit_ellipsoid_approx()
                self.approx_fit = True
            return float(self.map_lcb_ucb_approx_action(
                S, dt=dt, beta=self.beta(0))[1])
        raise AssertionError("Not implemented.")

    def map_lcb_ucb_approx(self, S, n, beta=2.0, delta=0.01):
        """Pointwise map/lcb/ucb on S's n-point grid, clipped to [b, B]."""
        xtest = S.return_discretization(n)
        if self.data is None:
            zeros = 0 * xtest[:, :1]
            return self.b + zeros, self.b + zeros, self.B + zeros
        self.fit_ellipsoid_approx()
        Phi = self.packing.embed(xtest)
        map_ = Phi @ self.rate.reshape(-1, 1)
        width = beta * torch.sqrt(torch.clamp(
            torch.einsum("ij,jk,ik->i", Phi, self.W_inv_approx, Phi), min=0))[:, None]
        return (map_, torch.clamp(map_ - width, min=self.b),
                torch.clamp(map_ + width, max=self.B))

    def map_lcb_ucb(self, S, n, beta=2.0):
        return self.map_lcb_ucb_approx(S, n, beta=beta)

    # -- acquisition functions -----------------------------------------------------
    def gap(self, S, actions, w, dt, beta=2.0):
        phi = self.packing.integral(S) * dt
        if self.approx is None:
            l, LG, u = self._slice_box()
            ucbs = []
            for _ in actions:
                ucb, _ = maximize_on_elliptical_slice(
                    phi, self.W, self.rate.reshape(-1), beta, l, LG, u)
                ucbs.append(float(ucb))
            return float(np.max(ucbs))
        if self.data is None:
            return (self.B - self.b) * S.volume()
        if not self.ucb_identified:
            self.ucb_identified = True
            self.fit_ellipsoid_approx()
            self.max_ucb = -np.inf
            self.ucb_action = None
            for action in actions:
                _, __, ucb = self.map_lcb_ucb_approx_action(
                    action, dt=dt, beta=self.beta(0))
                ucb = float(ucb) / w(action)
                if ucb > self.max_ucb:
                    self.max_ucb = ucb
                    self.ucb_action = action
        map_, lcb, ucb = self.map_lcb_ucb_approx_action(S, dt=dt,
                                                        beta=self.beta(0))
        return float(w(S) * self.max_ucb - lcb)

    def information(self, S, dt, precomputed=None):
        """Information-directed acquisition."""
        if self.data is None:
            return 1.0
        if self.W is None:
            self.construct_covariance_matrix()
        Wi = self.W_inv_approx
        if self.feedback == "count-record":
            v_ucb = self.packing.integral(self.ucb_action).reshape(1, -1) * dt
            if precomputed is not None:
                Ups = precomputed[S] * dt
            else:
                ind = [i for i, st in enumerate(self.basic_sets) if S.inside(st)]
                Ups = self.varphis[torch.as_tensor(ind, device=self.device)] * dt
            I = torch.eye(Ups.shape[0], dtype=Ups.dtype, device=Ups.device)
            G = Wi - Wi @ Ups.T @ torch.linalg.inv(I + Ups @ Ups.T) @ Ups @ Wi
            a = (v_ucb @ Wi @ v_ucb.T)[0, 0]
            b = (v_ucb @ G @ v_ucb.T)[0, 0]
            return float(1e-4 + torch.log(a) - torch.log(b))
        phi = self.packing.integral(S)
        return float(torch.log(1 + phi @ Wi @ phi * dt**2))

    # -- posterior sampling --------------------------------------------------------
    def _posterior_nll_grad(self):
        """(∇ nll, Hessian of nll, l, u, Γ^{1/2}, Γ^{-1/2}) of the penalised
        likelihood in w-coordinates."""
        l, Lambda, u = self.get_constraints()
        G_half, invG_half = self.cov(inverse=True)
        phis_raw = self.phis @ invG_half
        invG = invG_half.T @ invG_half
        if self.observations is not None:
            obs_raw = self.observations @ invG_half
            mult = self.obs_multiplicities

            def nll(w):
                lam = torch.clamp(obs_raw @ w, min=1e-10)
                reg = invG_half @ w
                return (-torch.sum(mult * torch.log(lam))
                        + torch.sum(phis_raw @ w)
                        + 0.5 * self.s * torch.sum(reg * reg))

            def hess(w):
                lam = torch.clamp(obs_raw @ w, min=1e-10)
                return ((obs_raw * (mult / lam**2)[:, None]).T @ obs_raw
                        + self.s * invG)
        else:
            def nll(w):
                reg = invG_half @ w
                return torch.sum(phis_raw @ w) + 0.5 * self.s * torch.sum(
                    reg * reg)

            def hess(w):
                return self.s * invG

        def grad(w):
            with torch.enable_grad():
                wg = w.detach().requires_grad_()
                (g,) = torch.autograd.grad(nll(wg), wg)
            return g

        return grad, hess, l, u, G_half, invG_half

    def sample(self, verbose=False, steps=1000, domain=None):
        """One posterior draw of θ by the `sampling` route's chain in w,
        its noise from the estimator's generator."""
        if self.steps is not None:
            steps = self.steps
        stepsize = self.stepsize
        if self.rate is None:
            self.fit_gp()
        grad_nll, hess_nll, l, u, G_half, invG_half = self._posterior_nll_grad()
        w0 = torch.clamp(G_half @ self.rate.reshape(-1), l + 1e-3, u - 1e-3)
        g = self.generator
        eta = stepsize if stepsize is not None else 1.0 / (self.get_m() ** 2)

        if self.sampling == "mirror":
            w = mirror_langevin_box(g, grad_nll, l, u, w0, steps=steps,
                                    step_size=eta)[-1]
        elif self.sampling in ("hessian", "hessian2"):
            # the reciprocal-map mirror Langevin on {w > l}: the reference's
            # Hessian-positive pair, exact at an identity constraint matrix
            xs = mirror_langevin_positive(g, grad_nll, l, w0, steps=steps,
                                          step_size=eta)
            w = torch.clamp(xs[-1], l, u)
        elif self.sampling == "mla_prime":
            xs = mla_prime_positive(g, grad_nll, l, w0, steps=steps,
                                    step_size=eta)
            w = torch.clamp(xs[-1], l, u)
        elif self.sampling == "newton":
            bar = 1e-2     # a log-barrier keeps the box

            def grad_b(w):
                return (grad_nll(w) - bar / torch.clamp(w - l, min=1e-10)
                        + bar / torch.clamp(u - w, min=1e-10))

            def hess_b(w):
                return hess_nll(w) + torch.diag(
                    bar / torch.clamp(w - l, min=1e-10) ** 2
                    + bar / torch.clamp(u - w, min=1e-10) ** 2)

            xs = newton_langevin(g, grad_b, hess_b, w0, steps=steps,
                                 step_size=1.0 if stepsize is None else stepsize)
            w = torch.clamp(xs[-1], l, u)
        elif self.sampling in ("proximal+prox", "proximal+simple_prox"):
            w = proximal_langevin(g, grad_nll,
                                  lambda t, _eta: torch.clamp(t, l, u), w0,
                                  steps=steps, step_size=eta)[-1]
        elif self.sampling == "projected":
            w = projected_langevin(g, grad_nll, lambda t: torch.clamp(t, l, u),
                                   w0, steps=steps, step_size=eta)[-1]
        elif self.sampling == "hmc":
            def log_prob(w):
                # a box barrier keeps the chain inside the constraint set
                barrier = torch.sum(torch.log(torch.clamp(w - l, min=1e-8))
                                    + torch.log(torch.clamp(u - w, min=1e-8))
                                    ) * 1e-3
                return -self._posterior_nll_value(w) + barrier

            xs, _ = hmc_sample(g, log_prob, w0, steps=max(steps // 10, 20),
                               leapfrog_steps=10,
                               step_size=eta if stepsize is not None else 1e-3)
            w = xs[-1]
        else:
            raise NotImplementedError("Sampling of such is not supported.")
        self.sampled_theta = invG_half @ w
        return self.sampled_theta

    def _posterior_nll_value(self, w):
        G_half, invG_half = self.cov(inverse=True)
        val = torch.sum((self.phis @ invG_half) @ w)
        if self.observations is not None:
            lam = torch.clamp((self.observations @ invG_half) @ w, min=1e-10)
            val = val - torch.sum(self.obs_multiplicities * torch.log(lam))
        reg = invG_half @ w
        return val + 0.5 * self.s * torch.sum(reg * reg)

    def sampled_lcb_ucb(self, xtest, samples=100, delta=0.1):
        """Quantile bands of `samples` posterior paths at xtest."""
        paths = []
        for _ in range(samples):
            self.sample()
            paths.append(self.sample_path_points(xtest).reshape(1, -1))
        paths = torch.cat(paths, dim=0)
        return (torch.quantile(paths, delta, dim=0),
                torch.quantile(paths, 1 - delta, dim=0))

    # -- conformal predictive sets -------------------------------------------------
    def add_data_point_and_remove(self, new):
        """Append a synthetic round; returns the saved state to restore."""
        saved = (self.phis, self.observations, self.obs_multiplicities,
                 self.counts)
        S, obs, dt = new
        self.phis = torch.cat(
            [self.phis, self.packing.integral(S).reshape(1, -1) * dt], dim=0)
        if obs is not None:
            emb = self.packing.embed(obs) * dt
            mult = torch.ones(emb.shape[0], dtype=self.dtype, device=self.device)
            self.observations = (torch.cat([self.observations, emb], dim=0)
                                 if self.observations is not None else emb)
            self.obs_multiplicities = (
                torch.cat([self.obs_multiplicities, mult])
                if self.obs_multiplicities is not None else mult)
            cnt = float(emb.shape[0])
        else:
            cnt = 0.0
        self.counts = torch.cat([self.counts, self._tensor([cnt])])
        return saved

    def _restore_data(self, saved):
        (self.phis, self.observations, self.obs_multiplicities,
         self.counts) = saved

    def conformal_score_func(self, theta, new, index):
        """Rank of the synthetic round's residual among the basic set's
        historical residuals."""
        S, obs, dt = new
        n_new = 0 if obs is None else obs.shape[0]
        varphi = self.packing.integral(S) * dt
        err_new = abs(float(n_new) - float(varphi @ theta))
        hist = np.asarray(self.bucketized_obs[index], dtype=float)
        n = len(hist)
        if n == 0:
            return 0.0
        pred = float(self.varphis[index] @ theta)
        errs = np.abs(hist - pred)
        return float(np.sum(errs < err_new)) / (n + 1.0) + 1.0 / (n + 1.0)

    def conformal_confidence_set(self, S, delta=0.05, max_val=20, dt=1.0,
                                 step=1):
        """Full-conformal count interval for S: sweep hypothesised counts j
        (j uniform points of S from the generator), refit with the
        synthetic round, and keep j while the score stays over the (1 − δ)
        quantile. Returns (map, ucb, lcb) as rates (counts/dt/vol)."""
        if self.data is None:
            return self.b, self.B, self.b
        self.fit_gp()
        index = 0
        for st in self.basic_sets:
            if st.inside(S):
                break
            index += 1
        map_ = float(self.rate @ self.packing.integral(S))

        def score_for(j):
            obs = S.uniform_sample(self.generator, j) if j > 0 else None
            new = (S, obs, dt)
            saved = self.add_data_point_and_remove(new)
            theta_new = self.penalized_likelihood_fast()
            self._restore_data(saved)
            return self.conformal_score_func(theta_new, new, index)

        n = float(len(self.bucketized_obs[index]))
        thresh = np.ceil((1 - delta) * (n + 1)) / (n + 1)
        lowest, j = 0, 0
        score = 1.0
        while score > thresh and j <= max_val:
            lowest = j
            score = score_for(j)
            j += step
        largest, j = max_val, max_val
        score = 1.0
        while score > thresh and j > lowest:
            largest = j
            score = score_for(j)
            j -= step
        self.fit_gp()      # refit on the clean data
        vol = S.volume()
        return map_, largest / dt / vol, lowest / dt / vol

    def conformal_confidence(self, delta=0.05, max_val=20, dt=1, step=1):
        out = [self.conformal_confidence_set(S, delta=delta, max_val=max_val,
                                             dt=dt, step=step)
               for S in self.basic_sets]
        maps, ucbs, lcbs = zip(*out)
        return self._tensor(maps), self._tensor(ucbs), self._tensor(lcbs)

    def mean_var_conformal_set(self, S, dt, beta=2.0, max_val=None,
                               delta=0.05):
        if max_val is None:
            max_val = int(self.B * self.basic_sets[0].volume() * dt) + 1
        map_, ucb, lcb = self.conformal_confidence_set(
            S, delta=delta, max_val=max_val, dt=dt)
        return map_, lcb, ucb

    def map_lcb_ucb_likelihood_ratio(self, S, n, delta=0.1, current=False):
        """Pointwise likelihood-ratio band on S's n-point grid."""
        xtest = S.return_discretization(n)
        if self.data is None:
            zeros = 0 * xtest[:, :1]
            return self.b + zeros, self.b + zeros, self.B + zeros
        Phi = self.packing.embed(xtest)
        map_ = Phi @ self.rate.reshape(-1, 1)
        lcbs, ucbs = [], []
        for i in range(Phi.shape[0]):
            _, u_i, l_i = self._lr_bound_direction(Phi[i], delta)
            ucbs.append(u_i)
            lcbs.append(l_i)
        return (map_, self._tensor(lcbs).reshape(-1, 1),
                self._tensor(ucbs).reshape(-1, 1))

    def _lr_bound_direction(self, x, delta):
        """xᵀθ's likelihood-ratio bounds (300 FISTA steps): (None, ucb, lcb)."""
        ucb, lcb = self._lr_bounds(x, delta, 300)
        return None, ucb, lcb

    def update_variances(self, value=False, force=False):
        self.approx_fit = True
