"""Data-generating noise models with explicit-generator sampling and
tensor log-likelihoods.

Port of stpy_tpu/probability/noise_models.py. Where the JAX package takes
a PRNG key, the port takes a `torch.Generator`; every draw goes through one
module-level helper per distribution (`_normal`, `_laplace`, `_uniform`,
`_gumbel`, `_rademacher`, `_bernoulli`, `_poisson`), each returning a
tensor of the asked shape on the model's device. The noise and the
observations are in `dtype` on `device` (the card unless the caller passes
another).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def _on(generator, device):
    return device if generator is None else generator.device


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=_on(generator, device)).to(device)


def _uniform(generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=_on(generator, device)).to(device)


def _laplace(generator, shape, dtype, device):
    """Standard Laplace by the inverse CDF of a uniform on (−1, 1)."""
    tiny = torch.finfo(dtype).tiny
    u = 2.0 * _uniform(generator, shape, dtype, device) - 1.0
    u = torch.clamp(u, min=-1.0 + tiny)
    return -torch.sign(u) * torch.log1p(-torch.abs(u))


def _gumbel(generator, shape, dtype, device):
    tiny = torch.finfo(dtype).tiny
    u = torch.clamp(_uniform(generator, shape, dtype, device), min=tiny)
    return -torch.log(-torch.log(u))


def _rademacher(generator, shape, dtype, device):
    return 2.0 * (_uniform(generator, shape, dtype, device) < 0.5).to(dtype) - 1.0


def _bernoulli(generator, p):
    return _uniform(generator, p.shape, p.dtype, p.device) < p


def _poisson(generator, rate):
    where = _on(generator, rate.device)
    return torch.poisson(rate.to(where), generator=generator).to(rate.device)


class NoiseModel(ABC):
    """Interface: sample noisy observations and evaluate their likelihood."""

    def __init__(self, device=None, dtype=torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _shape(self, xs):
        return (xs.shape[0], 1), self.dtype, self.device

    @abstractmethod
    def sample_noise(self, generator, xs):
        ...

    def sample(self, generator, xs, theta):
        xs = self._tensor(xs)
        return xs @ self._tensor(theta).reshape(-1, 1) + self.sample_noise(
            generator, xs)

    def noise_log_likelihood(self, etas):
        raise NotImplementedError

    def log_likelihood(self, ys, xs, theta):
        if ys.shape[0] == 0:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        return self.noise_log_likelihood(ys - xs @ theta.reshape(-1, 1))

    def joint_log_likelihood(self, ys, xs, theta):
        return torch.sum(self.log_likelihood(ys, xs, theta))

    @property
    def convex(self) -> bool:
        return False


class GaussianNoise(NoiseModel):
    def __init__(self, sigma=0.1, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.sigma = sigma

    def sample_noise(self, generator, xs):
        return self.sigma * _normal(generator, *self._shape(xs))

    def noise_log_likelihood(self, etas):
        return -0.5 * etas**2 / self.sigma**2 - 0.5 * np.log(
            2 * np.pi * self.sigma**2
        )

    @property
    def convex(self):
        return True

    def __str__(self):
        return "GaussianAdditive"


class HuberContaminatedNoise(NoiseModel):
    """Gaussian + Laplace mixture."""

    def __init__(self, sigma=0.1, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.sigma = sigma

    def sample_noise(self, generator, xs):
        g = _normal(generator, *self._shape(xs))
        l = _laplace(generator, *self._shape(xs)) * self.sigma
        return self.sigma * (g + l) / 2.0

    def noise_log_likelihood(self, etas, delta=1.35):
        a = torch.abs(etas) / self.sigma
        return -torch.where(a <= delta, 0.5 * a**2, delta * (a - 0.5 * delta))

    @property
    def convex(self):
        return True

    def __str__(self):
        return "HuberContaminated"


class BoundedNoise(GaussianNoise):
    """Uniform on [lower, upper] (sub-Gaussian bounded norm)."""

    def __init__(self, lower, upper, device=None, dtype=torch.float32):
        super().__init__(upper - lower, device=device, dtype=dtype)
        self.lower = lower
        self.upper = upper

    def sample_noise(self, generator, xs):
        u = _uniform(generator, *self._shape(xs))
        return self.lower + u * (self.upper - self.lower)

    def __str__(self):
        return "BoundedNoiseAdditive"


class MisspecifiedGaussianNoise(GaussianNoise):
    """Model assumes `sigma`, data generated with `actual_sigma`."""

    def __init__(self, sigma=1.0, actual_sigma=0.1, device=None,
                 dtype=torch.float32):
        super().__init__(sigma=sigma, device=device, dtype=dtype)
        self.actual_sigma = actual_sigma

    def sample_noise(self, generator, xs):
        return self.actual_sigma * _normal(generator, *self._shape(xs))

    def __str__(self):
        return "MisspecifiedGaussianAdditive"


class LaplaceNoise(NoiseModel):
    def __init__(self, b, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.b = b

    def sample_noise(self, generator, xs):
        return self.b * _laplace(generator, *self._shape(xs))

    def noise_log_likelihood(self, etas):
        return -np.log(2 * self.b) - torch.abs(etas) / self.b

    @property
    def convex(self):
        return True

    def __str__(self):
        return "Laplace"


class GumbelNoise(NoiseModel):
    def __init__(self, beta, mu=0.0, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.beta = beta
        self.mu = mu

    def sample_noise(self, generator, xs):
        return self.mu + self.beta * _gumbel(generator, *self._shape(xs))

    def noise_log_likelihood(self, etas):
        z = (etas - self.mu) / self.beta
        return -np.log(self.beta) - z - torch.exp(-z)

    def __str__(self):
        return "GumbelAdditive"


class TwoSidedWeibullNoise(NoiseModel):
    """Symmetrized Weibull: sign ~ Rademacher, |eta| ~ Weibull(k, lam)."""

    def __init__(self, k=1.5, lam=1.0, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.k = k
        self.lam = lam

    def sample_noise(self, generator, xs):
        u = _uniform(generator, *self._shape(xs))
        mag = self.lam * (-torch.log1p(-u)) ** (1.0 / self.k)
        sgn = _rademacher(generator, *self._shape(xs))
        return sgn * mag

    def noise_log_likelihood(self, etas):
        a = torch.abs(etas) / self.lam
        return (
            np.log(self.k / (2 * self.lam))
            + (self.k - 1) * torch.log(torch.clamp(a, min=1e-30))
            - a**self.k
        )

    def __str__(self):
        return "TwoSidedWeibull"


class LogWeibullNoise(NoiseModel):
    """log of Weibull magnitudes (heavy left tail)."""

    def __init__(self, k=1.0, lam=1.0, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.k = k
        self.lam = lam

    def sample_noise(self, generator, xs):
        u = _uniform(generator, *self._shape(xs))
        mag = self.lam * (-torch.log1p(-u)) ** (1.0 / self.k)
        return torch.log(torch.clamp(mag, min=1e-30))

    def __str__(self):
        return "LogWeibull"


class BernoulliNoise(NoiseModel):
    """y ~ Bernoulli(sigmoid(xθ)); not additive."""

    def sample(self, generator, xs, theta):
        p = torch.sigmoid(self._tensor(xs) @ self._tensor(theta).reshape(-1, 1))
        return _bernoulli(generator, p).to(self.dtype)

    def sample_noise(self, generator, xs):
        raise AttributeError("Bernoulli noise is not additive")

    def log_likelihood(self, ys, xs, theta):
        s = xs @ theta.reshape(-1, 1)
        return ys * s - torch.nn.functional.softplus(s)

    def __str__(self):
        return "Bernoulli"


class PoissonNoise(NoiseModel):
    """y ~ Poisson(lam(x)); `lam` is a rate function."""

    def __init__(self, lam, device=None, dtype=torch.float32):
        super().__init__(device=device, dtype=dtype)
        self.lam = lam

    def sample_noise(self, generator, xs):
        rate = self.lam(self._tensor(xs)).reshape(-1)
        return _poisson(generator, rate).to(self.dtype)[:, None]

    def sample(self, generator, xs, theta=None):
        return self.sample_noise(generator, xs)

    def mean(self, xs):
        return self.lam(xs)

    def __str__(self):
        return "Poisson"
