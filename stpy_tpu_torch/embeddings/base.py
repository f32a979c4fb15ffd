"""Embedding base: finite bases Φ with k(x, y) ≈ Φ(x)ᵀΦ(y).

Port of stpy_tpu/embeddings/base.py. The box integral of the trig
features is one complex product over all frequencies,

    ∫_box exp(i ωᵀx) dx = Π_j (e^{i ω_j b_j} − e^{i ω_j a_j}) / (i ω_j),

so ∫ cos = Re(Π) and ∫ sin = Im(Π), in complex64 or complex128 as W's dtype
says. Every embedding takes an explicit ``device`` (None: the card,
config.resolve_device) and ``dtype``.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def box_trig_integrals(W, bounds):
    """(∫_S cos(ω_kᵀx) dx, ∫_S sin(ω_kᵀx) dx) for every row ω_k of W (K, d)
    over the box S = Π_j [a_j, b_j]; two (K,) tensors of W's dtype. A zero
    frequency coordinate takes its limit b_j − a_j exactly."""
    bounds = as_tensor(bounds, device=W.device, dtype=W.dtype).reshape(-1, 2)
    a, b = bounds[:, 0], bounds[:, 1]
    cd = torch.complex128 if W.dtype == torch.float64 else torch.complex64
    iw = 1j * W.to(cd)
    num = torch.exp(iw * b) - torch.exp(iw * a)
    small = torch.abs(W) < 1e-12
    terms = torch.where(small, (b - a).to(cd),
                        num / torch.where(small, torch.ones_like(iw), iw))
    prod = torch.prod(terms, dim=1)
    return prod.real.to(W.dtype), prod.imag.to(W.dtype)


class Embedding:
    """Base class; subclasses define `embed(x) -> (n, m)`."""

    def __init__(
        self, gamma=0.1, nu=0.5, m=100, d=1, diameter=1.0, groups=None,
        kappa=1.0, kernel="squared_exponential", cosine=False, approx="rff",
        device=None, dtype=torch.float32, **kwargs,
    ):
        self.gamma = float(gamma)
        self.m = int(m)
        self.d = int(d)
        self.nu = nu
        self.kappa = kappa
        self.cosine = cosine
        self.diameter = diameter
        self.groups = groups
        self.kernel = kernel
        self.approx = approx
        self.gradient_avail = 0
        self._place(device, dtype)
        if self.m % 2 == 1:
            raise AssertionError("Number of random features has to be even.")

    def _place(self, device, dtype):
        """Set the device (None: the card) and dtype; for the subclasses
        that skip this initialiser."""
        self.device, self.dtype = resolve_device(device), dtype

    def _tensor(self, x):
        return as_tensor(x, device=self.device, dtype=self.dtype)

    def embed(self, x):
        raise AttributeError("Only derived classes can call this method.")

    def get_m(self) -> int:
        return self.m

    def integral(self, S):
        """∫_S Φ_i(x) dx for every basis index i, exact for the trig
        features (with `embed`'s √weight·√κ scaling); S is any object with
        box `.bounds` (d, 2)."""
        Icos, Isin = box_trig_integrals(self.W, S.bounds)
        sw = self._feature_scales()
        return torch.cat([sw * Icos, sw * Isin])

    def _feature_scales(self):
        raise AttributeError("Only derived classes can call this method.")
