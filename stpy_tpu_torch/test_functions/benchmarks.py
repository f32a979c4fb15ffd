"""Bayesian-optimisation test functions: the port of
stpy_tpu/test_functions/benchmarks.py.

`BenchmarkFunction` (eval / eval_noiseless / initial_guess / interval /
maximum / optimize) and its subclasses: Camelback, Quadratic, Polynomial,
Michalewicz, Styblinski-Tang, the additive overlap, a custom function, a
GP prior draw on a grid, a kernelized draw Φθ, the 1-D tutorial function,
MultiRKHS and a linear function. Each lives on the card (or `device`) in
`dtype`; its noise and initial guesses come from a `torch.Generator`
seeded with `seed` (default 0), where the JAX package splits a key.
`optimize` fits the port's ARD `GaussianProcess` by its evidence.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.kernels import KernelFunction
from stpy_tpu_torch.models.exact_gp import GaussianProcess
from stpy_tpu_torch.utils.helper import interval as interval_grid


def _normal(generator, shape, dtype):
    """Standard normals from `generator` on its device."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def _uniform(generator, shape, dtype):
    """Uniforms on [0, 1) from `generator` on its device."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device)


def _permutation(generator, n):
    """A random permutation of range(n) from `generator` on its device."""
    return torch.randperm(n, generator=generator, device=generator.device)


class BenchmarkFunction:
    def __init__(self, type="discrete", d=1, gamma=1.0, dts=None, s=0.05,
                 device=None, dtype=torch.float32, **kwargs):
        self.scale = 1.0
        self.type = type
        self.gamma = gamma
        self.d = d
        self.s = s
        self.dts = None
        self.groups = None
        self.device, self.dtype = resolve_device(device), dtype
        self._generator = torch.Generator(device=self.device).manual_seed(
            kwargs.get("seed", 0))

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def eval_noiseless(self, X):
        if X.shape[1] != self.d:
            raise AssertionError(
                "Invalid dimension for the Benchmark function ..."
            )

    def eval(self, X, sigma=None):
        X = self._tensor(X)
        z = self.eval_noiseless(X)
        sig = self.s if sigma is None else sigma
        noise = sig * _normal(self._generator, (X.shape[0], 1), self.dtype)
        return z / self.scale + noise.to(self.device)

    def optimum(self):
        return 1.0

    def maximum(self, xtest=None):
        if self.type == "discrete":
            self.max = float(torch.max(self.eval_noiseless(
                self._tensor(xtest))))
        else:
            self.max = self.maximum_continuous()
        return self.max

    def maximum_continuous(self):
        return 1.0

    def scale_max(self, xtest=None):
        self.scale = self.maximum(xtest=xtest)

    def return_params(self):
        return (self.gamma, self.groups, self.d)

    def bandwidth(self):
        return self.gamma

    def set_group_param(self, groups):
        self.groups = groups

    def bounds(self):
        return tuple([(-0.5, 0.5) for _ in range(self.d)])

    def initial_guess(self, N, adv_inv=False):
        hi = 0.0 if adv_inv else 0.5
        u = _uniform(self._generator, (N, self.d), self.dtype).to(self.device)
        return -0.5 + u * (hi + 0.5)

    def interval(self, n, L_infinity_ball=0.5):
        if n is None:
            return None
        return interval_grid(n, self.d, L_infinity_ball=L_infinity_ball,
                             device=self.device, dtype=self.dtype)

    def optimize(self, xtest, sigma, restarts=5):
        """Fit an ARD GP to noisy evaluations at xtest and fit its
        bandwidths by the evidence; the smallest becomes `gamma`."""
        xtest = self._tensor(xtest)
        ytest = self.eval(xtest, sigma=sigma)
        kernel = KernelFunction(
            kernel_name="ard", d=self.d, ard_gamma=np.ones(self.d) * 0.1,
            groups=self.groups, device=self.device, dtype=self.dtype,
        )
        GP = GaussianProcess(kernel=kernel, s=sigma, d=self.d)
        GP.fit_gp(xtest, ytest)
        GP.optimize_params(type="bandwidth", restarts=restarts)
        self.gamma = float(torch.min(kernel.params_dict["0"]["ard_gamma"]))
        return self.gamma


class CamelbackBenchmark(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d = 2

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        xx = X[:, 0] * 4
        yy = X[:, 1] * 2
        y = (
            (4.0 - 2.1 * xx**2 + xx**4 / 3.0) * xx**2
            + xx * yy
            + (-4.0 + 4 * yy**2) * yy**2
        )
        return (-y / 5.0).reshape(-1, 1) / self.scale


def _axis_weights(d, like):
    """diag(1, 2, 1, ..., 1)[:d, :d] of the quadratic benchmarks."""
    w = [1.0, 2.0] + [1.0] * (d - 2)
    return torch.diag(torch.tensor(w[:d], dtype=like.dtype,
                                   device=like.device))


class QuadraticBenchmark(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.type = "continuous"
        self.R = self._tensor(kwargs.get("R", np.eye(self.d)))

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        Xr = X @ self.R
        s = torch.sum((Xr @ _axis_weights(self.d, X)) ** 2, dim=1)
        return -s.reshape(-1, 1) / self.scale + 1

    def bandwidth(self):
        return 0.2


class PolynomialBenchmark(QuadraticBenchmark):
    def eval_noiseless(self, X):
        BenchmarkFunction.eval_noiseless(self, X)
        Xr = (X @ self.R) @ _axis_weights(self.d, X)
        s = (
            torch.sum(Xr**2, dim=1)
            + 0.5 * torch.sum(Xr**3, dim=1)
            + torch.sum(Xr**4, dim=1)
        )
        return -s.reshape(-1, 1) / self.scale + 1


class MichalBenchmark(BenchmarkFunction):
    _OPT = [2.93254, 2.34661, 1.64107, 1.24415, 0.999643, 0.834879, 2.1089,
            1.84835, 1.64448, 1.48089, 1.34678, 1.2349, 1.89701, 1.76194,
            1.64477, 1.54218, 1.45162, 1.37109, 1.81774, 1.0]

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.type = "continuous"
        self.R = self._tensor(kwargs.get("R", np.eye(self.d)))

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        Xr = (X @ self.R) / 0.75
        Xr = (Xr + 0.5) * np.pi
        ar = torch.arange(1, self.d + 1, dtype=X.dtype, device=X.device)
        s = torch.sin(Xr) * torch.sin(ar * Xr / np.pi) ** (2 * self.d)
        return torch.sum(s, dim=1).reshape(-1, 1) / self.scale

    def bandwidth(self):
        return 0.2

    def maximum_continuous(self):
        return float(self._OPT[self.d])


class StybTangBenchmark(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.type = "discrete"
        self.R = self._tensor(kwargs.get("R", np.eye(self.d)))

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        Xr = (X @ self.R) * 8
        Y = Xr**2
        s = torch.sum(Y**2 - 16.0 * Y + 5 * Xr, dim=1).reshape(-1, 1)
        return -(0.5 * s / (self.d * 200.0) + 0.5) / self.scale


class GeneralizedAdditiveOverlap(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.type = "continuous"

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        diffs = torch.diff(X, dim=1) / 0.25
        s = torch.sum(torch.exp(-(diffs**2)), dim=1).reshape(-1, 1)
        return 0.5 * s / self.scale

    def maximum_continuous(self):
        opt = torch.zeros((1, self.d), dtype=self.dtype, device=self.device)
        return float(self.eval_noiseless(opt)[0, 0])


class CustomBenchmark(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.f = kwargs.get("f")

    def set_eval(self, f, scale=1.0):
        self.f = f
        self.scale = scale

    def eval_noiseless(self, X):
        return self.f(X) / self.scale


class GaussianProcessSample(BenchmarkFunction):
    """Ground truth drawn from a GP prior on a fixed grid of n points per
    dimension; evaluated at the nearest grid point."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d = kwargs["d"]
        self.kernel_name = kwargs.get("name", "squared_exponential")
        self.gamma = kwargs["gamma"]
        self.sigma = kwargs["sigma"]
        self.n = kwargs["n"]
        self.sample(self.n)

    def sample(self, n):
        self.xtest = self.interval(n)
        GP = GaussianProcess(
            s=self.sigma, gamma=self.gamma, kernel_name=self.kernel_name,
            d=self.d, device=self.device, dtype=self.dtype,
        )
        self.values = GP.sample(self.xtest, generator=self._generator)

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        X = self._tensor(X)
        d2 = torch.sum((X[:, None, :] - self.xtest[None, :, :]) ** 2, dim=-1)
        idx = torch.argmin(d2, dim=1)
        return self.values[idx, :] / self.scale

    def initial_guess(self, N, adv_inv=False):
        perm = _permutation(self._generator, self.xtest.shape[0])
        x = self.xtest[perm[:N].to(self.device), :]
        return torch.sort(x, dim=0).values

    def scale_max(self, xtest=None):
        pass

    def optimize(self, xtest, sigma, restarts=5):
        pass


class KernelizedSample(BenchmarkFunction):
    """Truth Φ(x)ᵀθ with θ drawn from the prior."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d = kwargs["d"]
        self.sigma = kwargs["sigma"]
        self.embedding = kwargs["embed"]
        self.m = kwargs["m"]
        self.sample()

    def set_theta(self, theta):
        self.theta = self._tensor(theta).reshape(-1, 1)

    def set_cutoff(self, cutoff):
        self.theta = self.theta.clone()
        self.theta[cutoff:, 0] = 0.0

    def sample(self):
        self.theta = _normal(self._generator, (self.m, 1),
                             self.dtype).to(self.device)

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        return self.embedding.embed(self._tensor(X)) @ self.theta / self.scale

    def scale_max(self, xtest=None):
        pass

    def optimize(self, xtest, sigma, restarts=5):
        pass


class Simple1DFunction(BenchmarkFunction):
    """f(x) = −(1.4 − 3z) sin(18z), z = 1.2 (x + 0.5): the minimal
    end-to-end tutorial function."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d = kwargs.get("d", 1)

    def eval_noiseless(self, X):
        super().eval_noiseless(X)
        z = (X + 0.5) * 1.2
        return -(1.4 - 3 * z) * torch.sin(18 * z)

    def maximum(self, xtest):
        return float(torch.max(torch.abs(self.eval_noiseless(
            self._tensor(xtest)))))


class MultiRKHS(BenchmarkFunction):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.d = 1

    def eval_noiseless(self, X):
        return 10 * X**2

    def maximum(self, xtest=None):
        pass


class LinearBenchmark(BenchmarkFunction):
    def __init__(self, d, s, seed=0, device=None, dtype=torch.float32):
        super().__init__(d=d, s=s, seed=seed, device=device, dtype=dtype)
        self.theta = _normal(self._generator, (d, 1),
                             self.dtype).to(self.device)

    def eval_noiseless(self, X):
        return self._tensor(X) @ self.theta
