"""Typed configuration dataclasses for the string-dispatched estimator
options: the port of stpy_tpu/configs.py.

Every enum-valued field is checked when the config is made, so a typo
raises at once, and `.build()` makes the port's object on the card (or
`device`) in `dtype`. There is no `default_dtype`: the port has no global
dtype (config.py), so `build` takes it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, Optional

import torch

KERNELS = frozenset({
    "squared_exponential", "ard", "linear", "laplace", "matern",
    "ard_matern", "modified_matern", "full_squared_exponential",
    "full_matern", "polynomial", "polynomial_additive", "gibbs",
    "gibbs_custom", "tanh", "step", "angsim", "spectral", "wiener",
    "custom", "random_map",
})
POISSON_BASES = frozenset({
    "triangle", "bernstein", "splines", "nystrom", "overlap-splines",
    "faber", "optimal-positive", "custom",
})
POISSON_ESTIMATORS = frozenset({"likelihood", "least-sq", "bins"})
POISSON_FEEDBACK = frozenset({"count-record", "histogram"})
POISSON_UNCERTAINTY = frozenset({"laplace", "least-sq", "bins", "conformal",
                                 "ratio"})
POISSON_SAMPLING = frozenset({
    "proximal+prox", "mirror", "projected", "hmc", "variational",
})
GP_LOSSES = frozenset({"squared", "huber", "svr", "unif"})


def _check(value: str, allowed: frozenset, what: str) -> None:
    if value not in allowed:
        raise ValueError(
            f"{what}={value!r} is not one of {sorted(allowed)}"
        )


@dataclass(frozen=True)
class KernelConfig:
    """Validated spec for `KernelFunction` (kernels.py:171-261 dispatch)."""
    kernel_name: str = "squared_exponential"
    gamma: float = 1.0
    nu: float = 1.5
    kappa: float = 1.0
    d: int = 1
    ard_gamma: Optional[tuple] = None
    groups: Optional[tuple] = None
    power: int = 2
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        _check(self.kernel_name, KERNELS, "kernel_name")

    def build(self, device=None, dtype=torch.float32):
        from stpy_tpu_torch.kernels import KernelFunction

        kw: dict[str, Any] = dict(
            kernel_name=self.kernel_name, gamma=self.gamma, nu=self.nu,
            kappa=self.kappa, d=self.d, power=self.power, device=device,
            dtype=dtype, **self.extra,
        )
        if self.ard_gamma is not None:
            kw["ard_gamma"] = list(self.ard_gamma)
        if self.groups is not None:
            kw["groups"] = [list(g) for g in self.groups]
        return KernelFunction(**kw)


@dataclass(frozen=True)
class GPConfig:
    """Exact-GP spec (gauss_procc.py:18 constructor + loss dispatch)."""
    kernel: KernelConfig = field(default_factory=KernelConfig)
    s: float = 0.1
    loss: str = "squared"

    def __post_init__(self):
        _check(self.loss, GP_LOSSES, "loss")

    def build(self, device=None, dtype=torch.float32):
        from stpy_tpu_torch.models.exact_gp import GaussianProcess

        gp = GaussianProcess(kernel=self.kernel.build(device, dtype), s=self.s)
        if self.loss != "squared":
            gp.loss = self.loss
        return gp


@dataclass(frozen=True)
class PoissonRateConfig:
    """PoissonRateEstimator spec — validates every string-dispatch axis the
    reference threads through 30 kwargs (poisson_rate_estimator.py:20-78,
    189-230, 895-912)."""
    d: int = 1
    m: int = 100
    basis: str = "triangle"
    estimator: str = "likelihood"
    feedback: str = "count-record"
    uncertainty: str = "laplace"
    sampling: str = "proximal+prox"
    B: float = 1.0
    b: float = 0.0
    s: float = 1.0
    U: float = 1.0
    jitter: float = 1e-7
    beta: float = 2.0
    offset: float = 0.1
    dual: bool = False
    no_anchor_points: int = 1024
    constraints: bool = True
    var_cor_on: bool = True
    steps: Optional[int] = None
    stepsize: Optional[float] = None
    kernel: Optional[KernelConfig] = None

    def __post_init__(self):
        _check(self.basis, POISSON_BASES, "basis")
        _check(self.estimator, POISSON_ESTIMATORS, "estimator")
        _check(self.feedback, POISSON_FEEDBACK, "feedback")
        _check(self.uncertainty, POISSON_UNCERTAINTY, "uncertainty")
        _check(self.sampling, POISSON_SAMPLING, "sampling")

    def build(self, process, hierarchy, device=None, dtype=torch.float32,
              **overrides):
        from stpy_tpu_torch.point_processes.poisson_rate_estimator import (
            PoissonRateEstimator,
        )

        kw = {
            f.name: getattr(self, f.name)
            for f in fields(self)
            if f.name != "kernel"
        }
        kw["kernel_object"] = (self.kernel.build(device, dtype) if self.kernel
                               else None)
        kw.update(device=device, dtype=dtype)
        kw.update(overrides)
        return PoissonRateEstimator(process, hierarchy, **kw)
