"""Regularizers over the probability simplex (MKL weight priors).

Port of stpy_tpu/regularization/simplex_regularizer.py: each supplies a
smooth `eval` for the exponentiated-gradient MKL solver. The weights `w`
are kept as given (default: uniform, float64) and meet θ on θ's device
and dtype.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.regularization.regularizer import Regularizer


class ProbabilityRegularizer(Regularizer):
    def __init__(self, lam=1.0, w=None, d=1, **kwargs):
        super().__init__(lam)
        self.w = w if w is not None else torch.ones(d, dtype=torch.float64) / d
        self.d = d
        self.dcp = True
        self.name = "default"

    def _w(self, theta):
        return torch.as_tensor(self.w).to(device=theta.device,
                                          dtype=theta.dtype)

    def eval(self, theta):
        return torch.zeros((), dtype=theta.dtype, device=theta.device)


class SupRegularizer(ProbabilityRegularizer):
    """λ / max_i(w_i θ_i): favors concentrated weights."""

    def __init__(self, constrained=False, version="1", **kwargs):
        super().__init__(**kwargs)
        self.convex = False
        self.name = "sup"
        self.constrained = constrained
        self.version = version

    def eval(self, theta):
        # smooth max via logsumexp for a usable gradient
        t = 50.0
        smax = torch.log(torch.sum(torch.exp(t * self._w(theta) * theta))) / t
        return self.lam / torch.clamp(smax, min=1e-10)


class DirichletRegularizer(ProbabilityRegularizer):
    """-(w-1)ᵀ log θ Dirichlet prior."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.name = "dirichlet"

    def eval(self, theta):
        return -self.lam * torch.sum(
            (self._w(theta) - 1.0) * torch.log(torch.clamp(theta, min=1e-12))
        )


class WeightedAitchisonRegularizer(ProbabilityRegularizer):
    """2λ Σ log(θ)² Aitchison-geometry prior."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.dcp = False
        self.name = "aitchison"

    def eval(self, theta):
        return 2.0 * self.lam * torch.sum(
            torch.log(torch.clamp(theta, min=1e-12)) ** 2
        )


class L1MeasureRegularizer(ProbabilityRegularizer):
    """λ ||θ||₁."""

    def eval(self, theta):
        return self.lam * torch.sum(torch.abs(theta))
