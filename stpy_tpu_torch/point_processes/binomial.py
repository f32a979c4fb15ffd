"""Bernoulli (binomial-feedback) point process: sensing a set S returns a
binary outcome out of a pool; the rate p(S) = ∫_S Φᵀθ must satisfy
0 ≤ Λθ ≤ 1 over every basic set.

Port of stpy_tpu/point_processes/binomial.py: the simulator, the binomial
MAP fit with the polytope Λθ ∈ [0, 1] as a quadratic-hinge penalty (FISTA
with backtracking, opt/prox.py), the Laplace covariance, the ellipsoid-slice
bounds (opt/ellipsoid.py) and the penalised proximal Langevin sampler
(inference/langevin.py); and the logistic-link variant. The estimator takes
an explicit ``device`` (None: the card) and ``dtype``, and draws from a
`torch.Generator` seeded with 31 on that device, where the JAX package
holds PRNGKey(31).
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import resolve_device
from stpy_tpu_torch.embeddings.positive import TriangleEmbedding
from stpy_tpu_torch.inference.langevin import proximal_langevin
from stpy_tpu_torch.linalg import power_iteration
from stpy_tpu_torch.opt.ellipsoid import maximize_on_elliptical_slice
from stpy_tpu_torch.opt.prox import fista_backtracking
from stpy_tpu_torch.point_processes.link_estimators import _grad, softplus
from stpy_tpu_torch.point_processes.poisson_rate_estimator import jnp_pinv
from stpy_tpu_torch.point_processes.rate_estimator import RateEstimator


class BernoulliPointProcess:
    """Simulator over basic sets: `rate(S)` is the success probability."""

    def __init__(self, basic_sets, d=1, rate=None):
        self.basic_sets = basic_sets
        self.rate = rate
        self.d = d

    def is_basic(self, S):
        return any(s is S for s in self.basic_sets)

    def sample(self, generator, S, t=None, dt=None):
        """One Bernoulli draw of S: a uniform of `generator` below rate(S)
        (as `jax.random.bernoulli`). Returns (S, outcome, pool 1, dt, t)."""
        p = float(self.rate(S))
        u = float(torch.rand((), generator=generator, dtype=torch.float64,
                             device=generator.device))
        return (S, 1.0 if u < p else 0.0, 1.0, dt, t)


class BernoulliRateEstimator(RateEstimator):
    def __init__(self, hierarchy, d=1, m=100, kernel_object=None, B=1.0,
                 s=1.0, jitter=1e-7, b=0.0, basis="triangle", offset=0.1,
                 uncertainty="laplace", generator=None, device=None,
                 dtype=torch.float32):
        self.device, self.dtype = resolve_device(device), dtype
        self.d = d
        self.s = s
        self.b = b
        self.B = B
        self.uncertainty = uncertainty
        self.hierarchy = hierarchy
        self.kernel_object = kernel_object
        self.packing = TriangleEmbedding(
            d, m, kernel_object=kernel_object, B=1.0, b=0.0, offset=offset,
            s=np.sqrt(jitter), device=self.device, dtype=dtype)
        self.feedback = "histogram"
        self.data = None
        self.rate = None
        self.sampled_theta = None
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self.device).manual_seed(31))
        self.basic_sets = self.hierarchy.get_sets_level(self.hierarchy.levels)
        self.varphis = torch.stack([self.embed_set(S).reshape(-1)
                                    for S in self.basic_sets])

    def embed_set(self, S):
        return self.packing.integral(S).reshape(1, -1)

    def load_data(self, data):
        """data: a list of (S, count, pool, duration, time)."""
        self.data = None
        self.phis = None
        for datapoint in data:
            self.add_data_point(datapoint)

    def add_data_point(self, datapoint):
        S, count, pool, _duration, _time = datapoint
        phi = self.embed_set(S)
        if self.data is None:
            self.data = [datapoint]
            self.counts = self._tensor([count])
            self.pool = self._tensor([pool])
            self.phis = phi
        else:
            self.data.append(datapoint)
            self.counts = torch.cat([self.counts, self._tensor([count])])
            self.pool = torch.cat([self.pool, self._tensor([pool])])
            self.phis = torch.cat([self.phis, phi])

    # -- objective ----------------------------------------------------------------
    def _nll(self, theta):
        """The binomial negative log-likelihood plus s/2‖θ‖²."""
        p = torch.clamp((self.phis @ theta).reshape(-1), 1e-8, 1 - 1e-8)
        return (-torch.sum(self.counts * torch.log(p))
                - torch.sum((self.pool - self.counts) * torch.log(1 - p))
                + 0.5 * self.s * torch.sum(theta ** 2))

    def nabla(self, theta):
        if self.data is None:
            return self.s * theta.reshape(-1, 1)
        return _grad(self._nll)(theta.reshape(-1)).reshape(-1, 1)

    def _polytope_penalty(self, theta, rho=1e4):
        z = self.varphis @ theta
        return rho * (torch.sum(torch.clamp(z - 1.0, min=0.0) ** 2)
                      + torch.sum(torch.clamp(-z, min=0.0) ** 2))

    def fit_gp(self, threads=4):
        """The penalised binomial MAP: FISTA with backtracking (1000
        iterations) from θ = 0.1."""
        if self.data is None:
            self.rate = None
            return

        def obj(theta):
            return self._nll(theta) + self._polytope_penalty(theta)

        theta0 = torch.full((self.get_m(),), 0.1, dtype=self.dtype,
                            device=self.device)
        self.rate = fista_backtracking(obj, theta0, lambda t: t,
                                       max_iter=1000).x
        return self.rate

    # -- covariance and bounds -------------------------------------------------------
    def construct_covariance(self, theta):
        p = torch.clamp((self.phis @ theta.reshape(-1)).reshape(-1), 1e-8,
                        1 - 1e-8)
        D1 = self.counts / p ** 2
        D2 = (self.pool - self.counts) / (1 - p) ** 2
        W = (self.phis * (D1 + D2)[:, None]).T @ self.phis
        return W + self.s * torch.eye(self.get_m(), dtype=W.dtype,
                                      device=W.device)

    def construct_confidence(self):
        self.W = self.construct_covariance(self.rate)
        self.invW = jnp_pinv(self.W)

    def _slice(self, phi, beta, box=True):
        nb = self.varphis.shape[0]
        kw = {}
        if box:
            kw = dict(l=torch.zeros(nb, dtype=self.dtype, device=self.device),
                      Lambda=self.varphis,
                      u=torch.ones(nb, dtype=self.dtype, device=self.device))
        val, _ = maximize_on_elliptical_slice(phi, self.W, self.rate.reshape(-1),
                                              float(np.sqrt(beta)), **kw)
        return val

    def ucb(self, S, beta=8.0, delta=0.1):
        if self.rate is None:
            return 1.0
        self.construct_confidence()
        val = self._slice(self.embed_set(S).reshape(-1), beta)
        return float(torch.clamp(val, 0.0, 1.0))

    def lcb(self, S, beta=8.0, delta=0.1):
        if self.rate is None:
            return 0.0
        self.construct_confidence()
        val = self._slice(-self.embed_set(S).reshape(-1), beta)
        return float(torch.clamp(-val, 0.0, 1.0))

    def mean_set(self, S):
        return float(self.embed_set(S).reshape(-1) @ self.rate)

    # -- sampling -------------------------------------------------------------------
    def sample(self, steps=100, verbose=False):
        """Proximal Langevin on the penalised posterior from the fitted θ
        (or b + 0.05·U² without a fit), step 0.5/(λ_max(W) + 1)."""
        if self.rate is not None:
            theta0 = self.rate.reshape(-1)
        else:
            u = torch.rand((self.get_m(),), generator=self.generator,
                           dtype=self.dtype,
                           device=self.generator.device).to(self.device)
            theta0 = self.b + 0.05 * u ** 2
        nll_grad, pen_grad = _grad(self._nll), _grad(self._polytope_penalty)

        def grad_f(theta):
            g = nll_grad(theta) if self.data is not None else self.s * theta
            return g + pen_grad(theta)

        W = (self.construct_covariance(theta0) if self.data is not None
             else torch.eye(self.get_m(), dtype=self.dtype, device=self.device))
        L = power_iteration(W) + 1.0
        xs = proximal_langevin(self.generator, grad_f, lambda t, _eta: t, theta0,
                               steps=steps, step_size=float(0.5 / L))
        self.sampled_theta = xs[-1].reshape(-1, 1)
        return self.sampled_theta

    def get_m(self):
        return self.packing.get_m()


class LinkBernoulliRateEstimator(BernoulliRateEstimator):
    """Logistic link p(S) = σ(∫_S Φᵀθ): no polytope to keep p in (0, 1)."""

    def link(self, x):
        return torch.sigmoid(x)

    def _nll(self, theta):
        z = (self.phis @ theta).reshape(-1)
        return (-torch.sum(self.counts * z - self.pool * softplus(z))
                + 0.5 * self.s * torch.sum(theta ** 2))

    def _polytope_penalty(self, theta, rho=1e4):
        return torch.zeros((), dtype=theta.dtype, device=theta.device) * (
            theta.sum())

    def construct_covariance(self, theta):
        p = torch.sigmoid((self.phis @ theta.reshape(-1)).reshape(-1))
        Dw = self.pool * p * (1 - p)
        W = (self.phis * Dw[:, None]).T @ self.phis
        return W + self.s * torch.eye(self.get_m(), dtype=W.dtype,
                                      device=W.device)

    def mean_set(self, S):
        return float(torch.sigmoid(self.embed_set(S).reshape(-1) @ self.rate))

    def ucb(self, S, beta=8.0, delta=0.1):
        if self.rate is None:
            return 1.0
        self.construct_confidence()
        return float(torch.sigmoid(
            self._slice(self.embed_set(S).reshape(-1), beta, box=False)))

    def lcb(self, S, beta=8.0, delta=0.1):
        if self.rate is None:
            return 0.0
        self.construct_confidence()
        return float(torch.sigmoid(
            -self._slice(-self.embed_set(S).reshape(-1), beta, box=False)))
