"""Inhomogeneous Poisson point-process simulator.

Port of stpy_tpu/point_processes/poisson.py: `PoissonPointProcess` (rate,
rate integrals by Gauss-Legendre tensor quadrature, the discretized
multinomial sampler and the thinning sampler) and
`SeasonalPoissonPointProcess`. Draws come from an explicit
`torch.Generator` where the JAX package takes a key; a `rate` is a
function of a tensor of points (n, d) and dt returning (n, 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch


class PoissonPointProcess:
    """Ground-truth process with a known rate function λ(x)."""

    def __init__(self, d=1, B=1.0, b=0.2, rate=None, rate_volume=None):
        self.B = B
        self.d = d
        self.b = b
        self.rate = rate if rate is not None else self.rate_default
        self.rate_volume_f = rate_volume
        self.exact = True

    def rate_default(self, x, dt=1.0):
        val = self.B * torch.sum(
            torch.exp(-(x + 1)) * torch.sin(2 * x * math.pi) ** 2, dim=1
        ).reshape(-1, 1)
        return (val + self.b) * dt

    def rate_volume(self, S, dt=1.0, rate=None, n_quad=64):
        """∫_S λ by the n_quad-point Gauss-Legendre tensor rule."""
        if self.rate_volume_f is not None:
            return float(self.rate_volume_f(S)) * dt
        rate = rate if rate is not None else self.rate
        w, nodes = S.return_legendre_discretization(n_quad)
        return float(torch.sum(w * rate(nodes).reshape(-1))) * dt

    def rate_sets(self, Sets, dt=1.0):
        return [self.rate_volume(S, dt=dt) for S in Sets]

    def sample_discretized(self, generator, S, dt, n=50):
        """A Poisson count, then that many points placed on S's n-point
        grid with probabilities ∝ λ (the JAX package's categorical on
        log(λ + 1e-30)); None for a zero count."""
        lam = max(self.rate_volume(S, dt), 0.0)
        where = generator.device
        count = int(torch.poisson(torch.tensor(lam, dtype=torch.float64,
                                               device=where),
                                  generator=generator))
        if count == 0:
            return None
        x = S.return_discretization(n)
        r = torch.clamp(self.rate(x).reshape(-1) * dt, min=0.0)
        idx = torch.multinomial((r + 1e-30).to(where), count,
                                replacement=True, generator=generator)
        return x[idx.to(x.device), :]

    def sample_thinning(self, generator, S, dt=1.0, rate=None):
        """Rejection (thinning) sampler under the bound (B + b)·dt."""
        rate = rate if rate is not None else self.rate
        lam_bar = (self.B + self.b) * dt
        lam_tot = lam_bar * S.volume()
        where = generator.device
        n_prop = int(torch.poisson(torch.tensor(lam_tot, dtype=torch.float64,
                                                device=where),
                                   generator=generator))
        if n_prop == 0:
            return None
        props = S.uniform_sample(generator, n_prop)
        u = torch.rand((n_prop,), generator=generator, dtype=props.dtype,
                       device=where).to(props.device)
        acc = u < (rate(props).reshape(-1) * dt / lam_bar)
        pts = props[acc]
        return pts if pts.shape[0] > 0 else None

    def sample(self, generator, S, dt=1.0, verbose=False, rate=None):
        if self.exact:
            return self.sample_discretized(generator, S, dt)
        return self.sample_thinning(generator, S, dt=dt, rate=rate)

    def visualize(self, S, samples=2, n=64, dt=1.0, show=True, generator=None):
        import matplotlib.pyplot as plt

        generator = generator or torch.Generator().manual_seed(0)
        xtest = S.return_discretization(n)
        rate = self.rate(xtest)
        if self.d == 1:
            plt.plot(xtest.cpu().numpy(), rate.cpu().numpy(), lw=3,
                     label="rate")
            for _ in range(samples):
                x = self.sample(generator, S, dt=dt)
                if x is not None:
                    plt.plot(x.cpu().numpy(), np.zeros(x.shape[0]), "o",
                             label=f"sample n={x.shape[0]}")
            plt.legend()
        if show:
            plt.show()


class SeasonalPoissonPointProcess(PoissonPointProcess):
    """Time-modulated rate λ(x)·w(t)."""

    def __init__(self, *args, modulation=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.modulation = modulation if modulation is not None else (
            lambda t: 1.0 + 0.5 * np.sin(2 * np.pi * t)
        )

    def rate_at_time(self, x, t, dt=1.0):
        return self.rate(x, dt=dt) * self.modulation(t)

    def sample_at_time(self, generator, S, t, dt=1.0):
        mod = float(self.modulation(t))
        orig = self.rate
        try:
            self.rate = lambda x, dt=1.0: orig(x, dt) * mod
            return self.sample(generator, S, dt=dt)
        finally:
            self.rate = orig
