"""Link-function rate estimators: λ(x) = g(Φ(x)ᵀθ) for non-identity links.

Port of stpy_tpu/point_processes/link_estimators.py:
`PermanentalProcessRateEstimator` (the quadratic link λ = (Φθ)², with the
product integrals Ψ(S) = ∫_S ΦΦᵀ: the basis's closed form where it has
one for S, else Gauss-Legendre quadrature), the Gauss-Legendre nodes of
`_QuadratureNodesMixin`, and the softplus (`LogisticGaussProcess...`),
exp(−Φθ) (`ExpGaussProcess...`) and B·sigmoid (`LogGaussProcess...`) links.
The fits are unconstrained L-BFGS (opt/lbfgs.py), the samplers ULA
(inference/langevin.py), the per-action quadratic bounds the trust-region
solvers of opt/ellipsoid.py. Random starts come from the estimator's
`torch.Generator` (`_normal`), where the JAX package splits its key.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.embeddings.positive import TriangleEmbedding
from stpy_tpu_torch.inference.langevin import ula
from stpy_tpu_torch.linalg import power_iteration
from stpy_tpu_torch.opt.ellipsoid import (
    maximize_matrix_quadratic_on_ellipse,
    minimize_matrix_quadratic_on_ellipse,
)
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.point_processes.poisson_rate_estimator import (
    PoissonRateEstimator,
)


def _normal(generator, shape, dtype, device):
    """Standard normals of `shape` from `generator`, drawn in float64 (so
    an f32 and a float64 model on generators in the same state start from
    the same values), on `device` in `dtype`."""
    return torch.randn(shape, generator=generator, dtype=torch.float64,
                       device=generator.device).to(device, dtype)


def softplus(x):
    """log(1 + eˣ) over the whole range, as `jax.nn.softplus`."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _grad(fun):
    def g(theta):
        theta = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            (out,) = torch.autograd.grad(fun(theta), theta)
        return out
    return g


class PermanentalProcessRateEstimator(PoissonRateEstimator):
    """Quadratic link λ(x) = (Φ(x)ᵀθ)²."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.integration = "fixed_quad"
        self.product_integrals = {}
        mm = self.get_m()
        self.varLambdas = torch.zeros((len(self.basic_sets), mm, mm),
                                      dtype=self.dtype, device=self.device)
        if self.feedback == "count-record" and self.estimator == "least-sq":
            self.varLambdas = torch.stack(
                [self.product_integral(S) for S in self.basic_sets])
            self.variances = self._tensor(
                [S.volume() * self.B for S in self.basic_sets])
        self.sumLambda = None

    def product_integral(self, S):
        """Ψ(S)_ij = ∫_S Φ_i Φ_j: the basis's closed form where it has one
        for S, else a Gauss-Legendre rule (128 nodes in 1-D, 50 a dimension
        otherwise); cached per set. The triangle basis's closed form
        integrates over its whole domain box whatever S is (its docstring
        says so); the JAX package uses it for every set, so a leaf's Ψ
        there is the domain's and a fit on leaf rounds finds 1/(number of
        leaves) of the rate (ROADMAP Queue 3). Here a set smaller than the
        domain takes the quadrature."""
        key = id(S)
        if key in self.product_integrals:
            return self.product_integrals[key]
        Psi = None
        if hasattr(self.packing, "product_integral") and (
                not isinstance(self.packing, TriangleEmbedding)
                or self._is_basis_domain(S)):
            try:
                Psi = self.packing.product_integral(S)
            except (NotImplementedError, AssertionError, TypeError):
                Psi = None
        if Psi is None:
            w, nodes = S.return_legendre_discretization(128 if S.d == 1 else 50)
            Z = self.packing.embed(nodes)
            Psi = (Z * self._tensor(w)[:, None]).T @ Z
        self.product_integrals[key] = Psi
        return Psi

    def _is_basis_domain(self, S):
        """Whether S is the triangle basis's whole domain box, the one set
        its closed-form `product_integral` integrates over."""
        lo, hi = self.packing.interval
        return bool(np.all(S._bounds_np[:, 0] == lo)
                    and np.all(S._bounds_np[:, 1] == hi))

    def get_constraints(self):
        """The box b ≤ θ ≤ B on the raw θ (the quadratic link needs no
        positivity of Φθ)."""
        mm = self.get_m()
        eye = torch.eye(mm, dtype=self.dtype, device=self.device)
        return (torch.full((mm,), float(self.b), dtype=self.dtype,
                           device=self.device), eye,
                torch.full((mm,), float(self.B), dtype=self.dtype,
                           device=self.device))

    def load_data(self, data, times=False):
        super().load_data(data, times=False)
        self.sumLambda = self._zeros_mm()
        for S, _obs, dt in data:
            self.sumLambda = self.sumLambda + self.product_integral(S) * dt

    def add_data_point(self, new_data, times=False):
        PoissonRateEstimator.add_data_point(self, new_data, times=False)
        S, _obs, dt = new_data
        if self.sumLambda is None:
            self.sumLambda = self._zeros_mm()
        self.sumLambda = self.sumLambda + self.product_integral(S) * dt

    # -- fit ---------------------------------------------------------------------
    def _quadratic_nll(self, reg, dtype=None):
        """θ ↦ −Σ c log((oᵀθ)²) + θᵀ(ΣΨ dt)θ + reg·s‖θ‖², summed in the
        JAX package's order, on the data in `dtype` (default: the
        model's)."""
        dtype = dtype or self.dtype
        sumLambda, obs = self.sumLambda.to(dtype), self.observations
        mult = self.obs_multiplicities
        if obs is not None:
            obs, mult = obs.to(dtype), mult.to(dtype)

        def nll(theta):
            val = theta @ (sumLambda @ theta)
            if obs is not None:
                q = (obs @ theta) ** 2
                val = -torch.sum(mult * torch.log(torch.clamp(q, min=1e-12))) + val
            return val + reg * self.s * torch.sum(theta ** 2)
        return nll

    def penalized_likelihood(self, threads=4):
        """The MAP θ of the non-convex (sign-symmetric) objective: the best
        of 8 L-BFGS runs (1000 iterations) from normal draws. The objective
        and the L-BFGS run in float64 whatever the model's dtype: on f32
        values the zoom line search's Wolfe tests fail on rounding, ~12
        evaluations an iteration against ~1.07 in float64 (config 4's
        setup, 64 functions; the runs end unconverged at 1000 either way),
        and an f32 fit took 130 s on an H100."""
        f64 = torch.float64
        loss = self._quadratic_nll(0.5, f64)
        theta0s = _normal(self.generator, (8, self.get_m()), f64, self.device)
        results = [minimize_lbfgs(loss, t0, max_iter=1000) for t0 in theta0s]
        values = torch.stack([r.value.reshape(()) for r in results])
        best = int(torch.where(torch.isnan(values),
                               torch.full_like(values, float("inf")),
                               values).argmin())
        self.rate = results[best].x.to(self.dtype)
        return self.rate

    penalized_likelihood_fast = penalized_likelihood

    def fit_gp(self, threads=4):
        if self.data is None:
            self.rate = None
            return
        self.penalized_likelihood(threads)

    fit = fit_gp

    def construct_covariance_matrix_laplace(self, theta=None):
        """W = Φ_obsᵀ diag(c/max((oᵀθ)², b)) Φ_obs + 2ΣΨ dt + s·I."""
        if self.feedback != "count-record":
            raise AssertionError("Not implemented.")
        W = self._zeros_mm()
        th = self.rate if theta is None else theta
        if self.observations is not None:
            q = torch.clamp((self.observations @ th.reshape(-1)) ** 2,
                            min=float(self.b))
            Dw = self.obs_multiplicities / torch.clamp(q, min=1e-12)
            W = (self.observations * Dw[:, None]).T @ self.observations
        return self._plus_s(W + 2.0 * self.sumLambda)

    # -- posterior sampling ---------------------------------------------------------
    def _ula_sample(self, nll, steps, stepsize):
        W = self.construct_covariance_matrix_laplace()
        L = power_iteration(W) + 1.0
        xs = ula(self.generator, _grad(nll), self.rate.reshape(-1),
                 steps=steps,
                 step_size=(stepsize if stepsize is not None else 0.5 / L))
        self.sampled_theta = xs[-1].reshape(-1, 1)

    def sample(self, verbose=False, steps=100, stepsize=None):
        """ULA on the MAP objective from the fitted θ, step 0.5/(λ_max(W)+1)
        by default."""
        if self.data is None:
            self.sampled_theta = torch.zeros((self.get_m(), 1),
                                             dtype=self.dtype,
                                             device=self.device)
            return None
        self._ula_sample(self._quadratic_nll(0.5), steps, stepsize)
        return None

    # -- evaluation under the squared link ---------------------------------------------
    def mean_rate(self, S, n=128):
        return self.mean_rate_points(S.return_discretization(n))

    def mean_rate_points(self, xtest):
        return (self.packing.embed(xtest) @ self.rate.reshape(-1, 1)) ** 2

    def mean_set(self, S, dt=1):
        Z = self.product_integral(S)
        return (self.rate @ (Z @ self.rate)) * dt

    def sample_value(self, S):
        Z = self.product_integral(S)
        th = self.sampled_theta.reshape(-1)
        return th @ (Z @ th)

    def sample_path(self, S, n=128):
        xtest = S.return_discretization(n)
        return (self.packing.embed(xtest) @ self.sampled_theta) ** 2

    def sample_path_points(self, xtest):
        return (self.packing.embed(xtest)
                @ self.sampled_theta.reshape(-1, 1)) ** 2

    def mean_std_per_action(self, S, W, dt, beta):
        """(map, ucb, lcb) of θᵀΨ(S)θ over the ellipsoid, by the exact
        trust-region solvers."""
        Z = self.product_integral(S)
        rate = self.rate.reshape(-1)
        ucb, _ = maximize_matrix_quadratic_on_ellipse(Z, W, rate, beta)
        lcb, _ = minimize_matrix_quadratic_on_ellipse(Z, W, rate, beta)
        map_ = rate @ (Z @ rate)
        return dt * map_, dt * float(ucb), dt * float(lcb)

    def map_lcb_ucb_approx_action(self, S, dt=1.0, beta=2.0):
        phi = self.packing.integral(S)
        map_ = phi @ self.rate
        width = beta * torch.sqrt(phi @ self.W_inv_approx @ phi)
        ucb = torch.maximum((map_ + width) ** 2, (map_ - width) ** 2)
        ucb = torch.clamp(ucb, max=self.B * S.volume() * dt)
        return dt * map_ ** 2, 0.0, dt * ucb


class _QuadratureNodesMixin:
    """Gauss-Legendre nodes (embedded) and weights (times dt) of every
    sensing round, for the domain integrals of non-polynomial links."""

    discretization = 64

    def _round_nodes(self, S, dt):
        w, nodes = S.return_legendre_discretization(self.discretization)
        return self.packing.embed(nodes), self._tensor(w) * dt

    def load_data(self, data, times=False):
        super().load_data(data, times=False)
        pairs = [self._round_nodes(S, dt) for S, _obs, dt in data]
        self.nodes = torch.cat([p[0] for p in pairs])
        self.weights = torch.cat([p[1] for p in pairs])

    def add_data_point(self, new_data, times=False):
        super().add_data_point(new_data, times=False)
        S, _obs, dt = new_data
        emb, w = self._round_nodes(S, dt)
        if getattr(self, "nodes", None) is None:
            self.nodes, self.weights = emb, w
        else:
            self.nodes = torch.cat([self.nodes, emb])
            self.weights = torch.cat([self.weights, w])


class _LinkMAP:
    """The MAP fit of a link model: L-BFGS (500 iterations) on
    −Σ c log λ(o) + Σ w·Λ(node) + s‖θ‖² from `_theta0`."""

    def _link_loss(self, reg=1.0):
        """θ ↦ obs term + Σ w·node term + reg·s‖θ‖², in the JAX package's
        order."""
        weights, nodes = self.weights, self.nodes
        obs, mult = self.observations, self.obs_multiplicities

        def loss(theta):
            val = torch.sum(weights * self._node_term(nodes @ theta))
            if obs is not None:
                val = self._obs_term(obs @ theta, mult) + val
            return val + reg * self.s * torch.sum(theta ** 2)
        return loss

    def _theta0(self):
        return _normal(self.generator, (self.get_m(),), self.dtype,
                       self.device)

    def penalized_likelihood(self, threads=4):
        res = minimize_lbfgs(self._link_loss(), self._theta0(), max_iter=500)
        self.rate = res.x
        return self.rate

    def _link_points(self, xtest, theta):
        return self.link(self.packing.embed(xtest) @ theta.reshape(-1, 1))

    def mean_rate(self, S, n=128):
        return self.mean_rate_points(S.return_discretization(n))

    def mean_rate_points(self, xtest):
        return self._link_points(xtest, self.rate)


class LogisticGaussProcessRateEstimator(_LinkMAP, _QuadratureNodesMixin,
                                        PermanentalProcessRateEstimator):
    """Softplus link λ = log(1 + exp(Φθ))."""

    def logistic(self, x):
        return softplus(x)

    link = logistic

    def _node_term(self, z):
        return softplus(z)

    def _obs_term(self, z, mult):
        return -torch.sum(mult * torch.log(torch.clamp(softplus(z), min=1e-12)))


class ExpGaussProcessRateEstimator(_LinkMAP, _QuadratureNodesMixin,
                                   PermanentalProcessRateEstimator):
    """Exponential link λ = exp(−Φθ), fitted from θ = 0."""

    def link(self, z):
        return torch.exp(-z)

    def _node_term(self, z):
        return torch.exp(-z)

    def _obs_term(self, z, mult):
        return torch.sum(mult * z)

    def _theta0(self):
        return torch.zeros((self.get_m(),), dtype=self.dtype,
                           device=self.device)


class LogGaussProcessRateEstimator(_LinkMAP, _QuadratureNodesMixin,
                                   PermanentalProcessRateEstimator):
    """Scaled-sigmoid link λ = B·σ(Φθ) (the sigmoidal Gaussian Cox
    process)."""

    def sigmoid(self, x):
        return torch.sigmoid(x)

    def link(self, z):
        return self.B * torch.sigmoid(z)

    def _node_term(self, z):
        return self.B * torch.sigmoid(z)

    def _obs_term(self, z, mult):
        lam = self.B * torch.sigmoid(z)
        return -torch.sum(mult * torch.log(torch.clamp(lam, min=1e-12)))

    def construct_covariance_matrix_laplace(self, theta=None):
        th = (self.rate if theta is None else theta).reshape(-1)
        W = self._zeros_mm()
        if self.observations is not None:
            p = torch.sigmoid(self.observations @ th)
            Dw = self.obs_multiplicities * (1 - p) ** 2
            W = (self.observations * Dw[:, None]).T @ self.observations
        p_nodes = torch.sigmoid(self.nodes @ th)
        Dn = self.B * self.weights * p_nodes * (1 - p_nodes)
        return self._plus_s(W + (self.nodes * Dn[:, None]).T @ self.nodes)

    def sample(self, verbose=False, steps=100, stepsize=None):
        """ULA on the sigmoidal posterior (regulariser s/2‖θ‖²)."""
        if self.data is None:
            self.sampled_theta = torch.zeros((self.get_m(), 1),
                                             dtype=self.dtype,
                                             device=self.device)
            return None
        self._ula_sample(self._link_loss(0.5), steps, stepsize)
        return None

    def sample_value(self, S):
        w, nodes = S.return_legendre_discretization(64)
        Phi = self.packing.embed(nodes)
        return torch.sum(self._tensor(w) * self.B * torch.sigmoid(
            (Phi @ self.sampled_theta).reshape(-1)))

    def sample_path(self, S, n=128):
        return self.sample_path_points(S.return_discretization(n))

    def sample_path_points(self, xtest):
        return self._link_points(xtest, self.sampled_theta)
