"""GLM likelihood objects with confidence-set machinery.

Port of stpy_tpu/probability/likelihoods.py. Each likelihood emits one
torch objective θ ↦ negative log-likelihood (autograd gives its gradient
and Hessian), and confidence sets are returned as data: `EllipsoidSet`
(with the square root of the information matrix) or `LRSet` (a sublevel
set of the objective). The reference names `get_objective_cvxpy` /
`get_objective_torch` map to the same objective. The data live in `dtype`
on `device` (the card unless the caller passes another); θ must live
there too. Log-determinants and Hessian spectra of the confidence
parameters are taken in the data's dtype, as in the JAX package.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.linalg import symsqrt


@dataclass
class EllipsoidSet:
    """{θ : ||L (θ - center)||² ≤ beta} with L = V^{1/2}."""

    L: torch.Tensor
    center: torch.Tensor
    beta: float

    def contains(self, theta, tol=1e-7):
        r = self.L @ (theta - self.center)
        return torch.sum(r * r) <= self.beta + tol

    def as_slice_params(self):
        """(Sigma, mu, c) for maximize_on_elliptical_slice: the constraint
        (θ-μ)ᵀΣ(θ-μ) ≤ c² with Σ = LᵀL, c = sqrt(beta)."""
        beta = torch.as_tensor(self.beta, dtype=self.L.dtype,
                               device=self.L.device)
        return self.L.T @ self.L, self.center, torch.sqrt(beta)


@dataclass
class LRSet:
    """{θ : objective(θ) ≤ beta}: a likelihood-ratio sublevel set."""

    objective: Callable
    beta: float

    def contains(self, theta, tol=1e-7):
        return self.objective(theta) <= self.beta + tol

    def penalty(self, theta, rho=1e4):
        return rho * torch.clamp(self.objective(theta) - self.beta,
                                 min=0.0) ** 2


def _masked(t, mask):
    return t if mask is None else t * torch.as_tensor(mask).to(
        device=t.device, dtype=t.dtype)


def _slogdet(A):
    return torch.linalg.slogdet(A)[1]


class Likelihood(ABC):
    def __init__(self, device=None, dtype=torch.float32):
        self.fitted = False
        self.x = None
        self.y = None
        self.device = resolve_device(device)
        self.dtype = dtype

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    # -- data ------------------------------------------------------------------
    def load_data(self, D):
        self.x, self.y = self._tensor(D[0]), self._tensor(D[1]).reshape(-1, 1)
        self.fitted = False

    def add_data_point(self, d):
        x, y = self._tensor(d[0]), self._tensor(d[1]).reshape(-1, 1)
        self.x = torch.vstack([self.x, x]) if self.x is not None else x
        self.y = torch.vstack([self.y, y]) if self.y is not None else y
        self.fitted = False

    # -- abstract interface ----------------------------------------------------
    @abstractmethod
    def evaluate_datapoint(self, theta, d, mask=None):
        ...

    @abstractmethod
    def get_objective(self, mask=None) -> Callable:
        """Objective θ -> negative log-likelihood (sum over data)."""
        ...

    @abstractmethod
    def information_matrix(self, theta_fit=None, mask=None):
        ...

    @abstractmethod
    def scale(self, err=None, bound=None):
        ...

    def normalization(self, d):
        return 1.0

    # reference API names (get_objective_cvxpy/torch both map to this one)
    def get_objective_torch(self):
        return self.get_objective()

    def get_objective_cvxpy(self, mask=None):
        return self.get_objective(mask=mask)

    def evaluate_log(self, f):
        raise NotImplementedError

    # -- confidence machinery ----------------------------------------------------
    def confidence_parameter_likelihood_ratio(self, delta, params):
        """Running (sequential) likelihood-ratio radius: log(1/δ) + Σ_i
        masked loss of the in-sequence estimators."""
        evidence = params["evidence"]
        estimators = params["estimator_sequence"]
        val = 0.0
        for i in range(len(estimators) - 1):
            est = estimators[i]
            if est is not None:
                xx = self.x[i : i + 1]
                yy = self.y[i : i + 1]
                val = val + self.evaluate_datapoint(
                    est, (xx, yy), mask=evidence[i]
                )
        return float(np.log(1.0 / delta) + val)

    def lr_confidence_set(self, beta, params) -> LRSet:
        evidence = torch.as_tensor(np.asarray(params["evidence"])).to(
            device=self.device, dtype=torch.bool)
        return LRSet(self.get_objective(mask=evidence), beta)

    def confidence_parameter_prior_posterior(self, delta, params):
        H = torch.as_tensor(params["regularizer_hessian"]).to(self.x)
        sigma = params["sigma"]
        n = self.x.shape[0]
        K = self.x @ self.x.T + torch.max(H) * sigma**2 * torch.eye(
            n, dtype=self.x.dtype, device=self.x.device
        )
        ev = (
            -0.5 * (self.y.T @ torch.linalg.solve(K, self.y))[0, 0]
            - 0.5 * _slogdet(K)
        )
        return float(np.log(1.0 / delta) - ev)

    def get_confidence_set(self, theta_fit, type=None, params=None, delta=0.1):
        """Default: Laplace/information ellipsoid. Subclasses refine."""
        params = params or {}
        H = params.get("regularizer_hessian")
        V = self.information_matrix(theta_fit)
        if H is not None:
            V = V + H
        L = symsqrt(V)
        beta = self.confidence_parameter(delta, params, type=type)
        return EllipsoidSet(L=L, center=theta_fit, beta=beta)

    def confidence_parameter(self, delta, params, type=None):
        return 2.0

    # reference name
    def get_confidence_set_cvxpy(self, theta, type=None, params=None,
                                 delta=0.1):
        return self.get_confidence_set(
            params.get("estimate") if params else theta, type, params, delta
        )

    def _adaptive_ab(self, delta, params, V):
        H = torch.as_tensor(params["regularizer_hessian"]).to(self.x)
        lam = float(torch.max(torch.linalg.eigvalsh(H)))
        B = params["bound"]
        V = V + H
        return float(
            2 * np.log(1.0 / delta)
            + _slogdet(V + H)
            - _slogdet(H)
            + lam * B
        )


class GaussianLikelihood(Likelihood):
    """Squared loss /(2σ²), optionally with full noise covariance."""

    def __init__(self, sigma=0.1, Sigma=None, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.sigma = sigma
        self.Sigma = self._tensor(Sigma) if Sigma is not None else None

    def scale(self, err=None, bound=None):
        if self.Sigma is None:
            return self.sigma**2
        return float(torch.max(self.Sigma.T @ self.Sigma))

    def _prec(self):
        return torch.linalg.inv(self.Sigma.T @ self.Sigma)

    def evaluate_log(self, f):
        if self.Sigma is None:
            return torch.sum((f - self.y) ** 2) / self.sigma**2
        r = f - self.y
        return (r.T @ self._prec() @ r)[0, 0]

    def evaluate_datapoint(self, theta, d, mask=None):
        x, y = d
        m = 1.0 if mask is None else mask
        r = x @ theta - y
        if self.Sigma is None:
            return torch.sum(m * r**2) / (2 * self.sigma**2)
        return m * (r.T @ self._prec() @ r)[0, 0]

    def normalization(self, d):
        return 1.0 / np.sqrt(2 * np.pi * self.sigma**2)

    def get_objective(self, mask=None):
        x, y = self.x, self.y

        def obj(theta):
            r = _masked((x @ theta.reshape(-1, 1) - y).reshape(-1), mask)
            if self.Sigma is None:
                return torch.sum(r * r) / (2 * self.sigma**2)
            return r @ (self._prec() @ r) / 2.0

        return obj

    def information_matrix(self, theta_fit=None, mask=None):
        x = self.x if mask is None else self.x[torch.as_tensor(mask)]
        if self.Sigma is None:
            return x.T @ x / (2 * self.sigma**2)
        return x.T @ self._prec() @ x / 2.0

    def confidence_parameter(self, delta, params, type=None):
        if type in (None, "none", "fixed", "laplace"):
            return 2.0
        if type == "adaptive-AB":
            return self._adaptive_ab(delta, params, self.information_matrix())
        if type == "LR":
            return self.confidence_parameter_likelihood_ratio(delta, params)
        if type == "prior-posterior":
            return self.confidence_parameter_prior_posterior(delta, params)
        raise NotImplementedError(type)

    def get_confidence_set(self, theta_fit, type=None, params=None, delta=0.1):
        params = params or {}
        if type == "LR":
            beta = self.confidence_parameter_likelihood_ratio(delta, params)
            return self.lr_confidence_set(beta, params)
        return super().get_confidence_set(theta_fit, type, params, delta)


class PoissonLikelihoodCanonical(GaussianLikelihood):
    """Poisson with exp link: -yᵀXθ + Σ exp(Xθ)."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)

    def link(self, s):
        return torch.exp(s)

    def scale(self, err=None, bound=None):
        return np.exp(bound)

    def evaluate_datapoint(self, theta, d, mask=None):
        x, y = d
        m = 1.0 if mask is None else mask
        s = (x @ theta).reshape(-1)
        return torch.sum(m * (-y.reshape(-1) * s + torch.exp(s)))

    def get_objective(self, mask=None):
        x, y = self.x, self.y

        def obj(theta):
            s = (x @ theta.reshape(-1, 1)).reshape(-1)
            return torch.sum(_masked(-y.reshape(-1) * s + torch.exp(s), mask))

        return obj

    def _weights(self, theta_fit):
        return torch.exp((self.x @ theta_fit.reshape(-1, 1)).reshape(-1))

    def information_matrix(self, theta_fit=None, mask=None):
        if theta_fit is None:
            return self.x.T @ self.x
        return (self.x * self._weights(theta_fit)[:, None]).T @ self.x

    def confidence_parameter(self, delta, params, type=None):
        if type in (None, "none", "laplace", "mutny"):
            return 2.0 * np.log(1.0 / delta) if type == "mutny" else 2.0
        if type == "adaptive-AB":
            V = self.x.T @ self.x / (1.0 / 4.0) ** 2
            return self._adaptive_ab(delta, params, V)
        if type == "LR":
            return self.confidence_parameter_likelihood_ratio(delta, params)
        raise NotImplementedError(type)

    def get_confidence_set(self, theta_fit, type=None, params=None, delta=0.1):
        params = params or {}
        H = params.get("regularizer_hessian")
        if type == "LR":
            beta = self.confidence_parameter_likelihood_ratio(delta, params)
            return self.lr_confidence_set(beta, params)
        if type == "mutny":
            V = self.x.T @ self.x * np.exp(params["bound"])
        else:
            # laplace (default): weights from the fit
            V = (self.x * self._weights(theta_fit)[:, None]).T @ self.x
        if H is not None:
            V = V + H
        return EllipsoidSet(symsqrt(V), theta_fit, 2.0 * np.log(1.0 / delta))


class BernoulliLikelihoodCanonical(GaussianLikelihood):
    """Logistic loss; y ∈ {0, 1}."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)

    def link(self, s):
        return torch.sigmoid(s)

    def scale(self, err=None, bound=None):
        return 0.25

    def evaluate_datapoint(self, theta, d, mask=None):
        x, y = d
        m = 1.0 if mask is None else mask
        s = (x @ theta).reshape(-1)
        return torch.sum(m * (torch.nn.functional.softplus(s)
                              - y.reshape(-1) * s))

    def get_objective(self, mask=None):
        x, y = self.x, self.y

        def obj(theta):
            s = (x @ theta.reshape(-1, 1)).reshape(-1)
            t = torch.nn.functional.softplus(s) - y.reshape(-1) * s
            return torch.sum(_masked(t, mask))

        return obj

    def information_matrix(self, theta_fit=None, mask=None):
        if theta_fit is None:
            return self.x.T @ self.x * 0.25
        p = torch.sigmoid((self.x @ theta_fit.reshape(-1, 1)).reshape(-1))
        w = p * (1 - p)
        return (self.x * w[:, None]).T @ self.x

    def get_confidence_set(self, theta_fit, type=None, params=None, delta=0.1):
        params = params or {}
        H = params.get("regularizer_hessian")
        if type == "LR":
            beta = self.confidence_parameter_likelihood_ratio(delta, params)
            return self.lr_confidence_set(beta, params)
        V = self.information_matrix(theta_fit)
        if H is not None:
            V = V + H
        return EllipsoidSet(symsqrt(V), theta_fit, 2.0 * np.log(1.0 / delta))


class LaplaceLikelihood(GaussianLikelihood):
    """L1 loss / b."""

    def __init__(self, b=0.1, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.b = b

    def scale(self, err=None, bound=None):
        return 2 * self.b**2

    def evaluate_datapoint(self, theta, d, mask=None):
        x, y = d
        m = 1.0 if mask is None else mask
        return torch.sum(m * torch.abs((x @ theta - y).reshape(-1))) / self.b

    def get_objective(self, mask=None):
        x, y = self.x, self.y

        def obj(theta):
            r = torch.abs((x @ theta.reshape(-1, 1) - y).reshape(-1))
            return torch.sum(_masked(r, mask)) / self.b

        return obj

    def information_matrix(self, theta_fit=None, mask=None):
        return self.x.T @ self.x / (2 * self.b**2)


def _huber(a, d):
    return torch.where(a <= d, 0.5 * a**2, d * (a - 0.5 * d))


class HuberLikelihood(GaussianLikelihood):
    """Huber loss."""

    def __init__(self, sigma=0.1, delta=1.35, device=None, dtype=torch.float32):
        super().__init__(sigma=sigma, device=device, dtype=dtype)
        self.delta_h = delta

    def get_objective(self, mask=None):
        x, y, s, d = self.x, self.y, self.sigma, self.delta_h

        def obj(theta):
            r = (x @ theta.reshape(-1, 1) - y).reshape(-1) / s
            return torch.sum(_masked(_huber(torch.abs(r), d), mask))

        return obj

    def evaluate_datapoint(self, theta, d_, mask=None):
        x, y = d_
        m = 1.0 if mask is None else mask
        r = (x @ theta - y).reshape(-1) / self.sigma
        return torch.sum(m * _huber(torch.abs(r), self.delta_h))


class WeibullLikelihoodCanonical(GaussianLikelihood):
    """Weibull GLM with canonical (log) link: y > 0,
    -log p = k·Xθ + y^k exp(-k Xθ) + const."""

    def __init__(self, kk=1.0, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.kk = kk

    def scale(self, err=None, bound=None):
        return 1.0

    def evaluate_datapoint(self, theta, d, mask=None):
        x, y = d
        m = 1.0 if mask is None else mask
        s = (x @ theta).reshape(-1)
        k = self.kk
        return torch.sum(m * (k * s + y.reshape(-1) ** k * torch.exp(-k * s)))

    def get_objective(self, mask=None):
        x, y, k = self.x, self.y, self.kk

        def obj(theta):
            s = (x @ theta.reshape(-1, 1)).reshape(-1)
            t = k * s + y.reshape(-1) ** k * torch.exp(-k * s)
            return torch.sum(_masked(t, mask))

        return obj

    def information_matrix(self, theta_fit=None, mask=None):
        return self.x.T @ self.x * self.kk**2


class RobustGraphicalLikelihood(LaplaceLikelihood):
    """Contamination-robust L1-type likelihood: a Bernoulli `coin` gives the
    contamination probability and `supp` the contamination support; the
    clean-part objective is the σ-scaled L1 loss."""

    def __init__(self, coin, supp, sigma=0.1, device=None,
                 dtype=torch.float32):
        super().__init__(b=sigma, device=device, dtype=dtype)
        self.coin = coin
        self.supp = supp
        self.sigma = sigma

    def get_objective(self, mask=None):
        x, y = self.x, self.y

        def obj(theta):
            r = torch.abs((x @ theta.reshape(-1, 1) - y).reshape(-1)) / self.sigma
            return torch.sum(_masked(r, mask))

        return obj

    def information_matrix(self, theta_fit=None, mask=None):
        return self.x.T @ self.x / (2 * self.sigma**2)
