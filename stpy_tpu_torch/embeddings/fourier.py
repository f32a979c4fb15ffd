"""Fourier-feature embeddings: random (RFF, orthogonal, Halton QMC) and
deterministic quadrature (Gauss-Legendre through the cot transform,
Hermite, trapezoidal, Clenshaw-Curtis, Matérn, periodic, lattice).

Port of stpy_tpu/embeddings/fourier.py. The frequencies W and weights are
built on the host in numpy float64 exactly as there, so the same seed gives
the same W, then stored in the embedding's dtype on its device. `embed` is
one (n, d) × (d, m/2) product and the trig functions,

    Φ(x) = √κ · [√w ⊙ cos(Wx); √w ⊙ sin(Wx)]      (m/2 frequencies),

plain torch ops (the JAX package computes them in XLA, outside any Pallas
kernel). For d > 1 the quadrature grid is the JAX package's sign-
symmetrised tensor grid (`QuadratureEmbedding.compute`).
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.embeddings.base import Embedding, box_trig_integrals
from stpy_tpu_torch.utils.helper import cartesian


def _halton(n: int, d: int) -> np.ndarray:
    """Halton low-discrepancy sequence in [0, 1)^d."""
    def vdc(n, base):
        seq = np.zeros(n)
        for i in range(n):
            q, denom = 0.0, 1.0
            k = i + 1
            while k > 0:
                denom *= base
                k, rem = divmod(k, base)
                q += rem / denom
            seq[i] = q
        return seq

    primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]
    assert d <= len(primes)
    return np.stack([vdc(n, primes[j]) for j in range(d)], axis=1)


def _gauss_inverse_cdf(u: np.ndarray) -> np.ndarray:
    """Acklam's rational approximation of the normal inverse CDF."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    u = np.clip(u, 1e-12, 1 - 1e-12)
    out = np.empty_like(u)
    plow, phigh = 0.02425, 1 - 0.02425
    lo = u < plow
    hi = u > phigh
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(u[lo]))
    out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
        (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
    )
    q = u[mid] - 0.5
    r = q * q
    out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / (
        ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1
    )
    q = np.sqrt(-2 * np.log(1 - u[hi]))
    out[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / (
        (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
    )
    return out


def _chi_sample(df: int, size: int, rng) -> np.ndarray:
    return np.sqrt(rng.chisquare(df, size=size))


class _TrigEmbedding(Embedding):
    """[cos; sin] feature maps with per-frequency weights. Subclasses set
    self.W (m/2, d) and self.weights (m/2,) through `_set_frequencies`."""

    def _set_frequencies(self, W, weights):
        self.W = self._tensor(W)
        self.weights = self._tensor(weights)

    def _feature_scales(self):
        return torch.sqrt(self.weights) * float(np.sqrt(self.kappa))

    def _angles(self, x):
        return self._tensor(x).reshape(-1, self.d) @ self.W.T

    def embed(self, x):
        q = self._angles(x)
        sw = self._feature_scales()
        return torch.cat([sw * torch.cos(q), sw * torch.sin(q)], dim=1)

    def derivative_1(self, x):
        """dΦ/dx, (n, m, d)."""
        q = self._angles(x)
        sw = self._feature_scales()
        dcos = -(sw * torch.sin(q))[:, :, None] * self.W[None, :, :]
        dsin = (sw * torch.cos(q))[:, :, None] * self.W[None, :, :]
        return torch.cat([dcos, dsin], dim=1)

    def derivative_2(self, x):
        """d²Φ/dx², (n, m, d, d)."""
        q = self._angles(x)
        sw = self._feature_scales()
        ww = self.W[:, :, None] * self.W[:, None, :]
        d2cos = -(sw * torch.cos(q))[:, :, None, None] * ww[None]
        d2sin = -(sw * torch.sin(q))[:, :, None, None] * ww[None]
        return torch.cat([d2cos, d2sin], dim=1)

    def product_integral(self, S):
        """Ψ_ij = ∫_S Φ_i Φ_j dx, the whole (m, m) matrix from two box
        integrals of the frequency sums and differences (product-to-sum)."""
        W = self.W
        h = W.shape[0]
        Wm = (W[:, None, :] - W[None, :, :]).reshape(h * h, -1)
        Wp = (W[:, None, :] + W[None, :, :]).reshape(h * h, -1)
        Icm, Ism = (t.reshape(h, h) for t in box_trig_integrals(Wm, S.bounds))
        Icp, Isp = (t.reshape(h, h) for t in box_trig_integrals(Wp, S.bounds))
        cc = 0.5 * (Icm + Icp)          # cos_i cos_j = ½[cos(Δ)+cos(Σ)]
        ss = 0.5 * (Icm - Icp)          # sin_i sin_j = ½[cos(Δ)-cos(Σ)]
        sc = 0.5 * (Isp + Ism)          # sin_i cos_j = ½[sin(Σ)+sin(Δ)]
        cs = 0.5 * (Isp - Ism)          # cos_i sin_j = ½[sin(Σ)-sin(Δ)]
        sw = self._feature_scales()
        outer = sw[:, None] * sw[None, :]
        top = torch.cat([outer * cc, outer * cs], dim=1)
        bot = torch.cat([outer * sc, outer * ss], dim=1)
        return torch.cat([top, bot], dim=0)


class RFFEmbedding(_TrigEmbedding):
    """Random Fourier features over m/2 frequencies: the SE or Laplace
    spectral density sampled plainly ("rff"), by a Halton sequence
    ("halton") or as orthogonal random features ("orf"); numpy's
    `default_rng(seed)` draws them, as in the JAX package."""

    def __init__(self, biased=False, seed=0, **kwargs):
        super().__init__(**kwargs)
        self.biased = biased
        self.seed = seed
        self.sample()

    def sample(self):
        rng = np.random.default_rng(self.seed)
        h, d = self.m // 2, self.d
        if self.approx == "rff":
            if self.kernel == "squared_exponential":
                W = rng.standard_normal((h, d)) / self.gamma
            elif self.kernel == "laplace":
                W = np.tan(np.pi * (rng.uniform(size=(h, d)) - 0.5)) / self.gamma
            else:
                raise AssertionError(f"RFF sampler for {self.kernel} missing")
        elif self.approx == "halton":
            u = _halton(h, d)
            if self.kernel == "squared_exponential":
                W = _gauss_inverse_cdf(u) / self.gamma
            elif self.kernel == "laplace":
                W = np.tan(np.pi * u - np.pi / 2) / self.gamma
            else:
                raise AssertionError("Halton sampler needs inverse CDF")
        elif self.approx == "orf":
            blocks = []
            remaining = h
            while remaining > 0:
                G = rng.standard_normal((d, d))
                Q, _ = np.linalg.qr(G)
                S = _chi_sample(d, d, rng)
                blocks.append(S[:, None] * Q)
                remaining -= d
            W = np.concatenate(blocks, axis=0)[:h] / self.gamma
        else:
            raise AssertionError(f"approx={self.approx} unknown")
        self._set_frequencies(W, np.full((h,), 2.0 / self.m))


class QuadratureEmbedding(_TrigEmbedding):
    """Deterministic quadrature Fourier features: a tensor grid of a 1-D
    rule through the cot transform and the kernel's spectral density."""

    def __init__(self, scale=1.0, **kwargs):
        super().__init__(**kwargs)
        self.scale = scale
        self.compute()

    def transform(self):
        """The kernel's spectral density, on (k, d) frequencies."""
        if self.kernel == "squared_exponential":
            return lambda om: (
                np.exp(-np.sum(om**2, axis=1) / 2 * self.gamma**2)
                * (self.gamma / np.sqrt(2 * np.pi)) * (np.pi / 2)
            )
        if self.kernel == "laplace":
            return lambda om: (
                np.prod(1.0 / (self.gamma**2 * om**2 + 1.0), axis=1)
                * (self.gamma / 2.0)
            )
        if self.kernel == "modified_matern":
            consts = {2: 1.0, 3: 4.0 / 3, 4: 8.0 / 5}
            nu = int(self.nu)
            return lambda om: (
                np.prod(1.0 / (self.gamma**2 * om**2 + 1.0) ** nu, axis=1)
                * self.gamma * consts[nu]
            )
        raise AssertionError(f"no spectral density for {self.kernel}")

    def nodesAndWeights(self, q):
        """Gauss-Legendre on (0, 1), cot-transformed to (0, ∞), weights
        times the spectral density."""
        om, w = np.polynomial.legendre.leggauss(2 * q)
        om, w = om[q:], 2 * w[q:]
        om = (om + 1.0) / 2.0 * np.pi
        sine_scale = 1.0 / np.sin(om) ** 2
        nodes = self.scale / np.tan(om)
        prob = self.transform()
        weights = self.scale * sine_scale * w * prob(nodes.reshape(-1, 1))
        return nodes, weights

    def compute(self, complexity_reorder=True):
        """Tensorise the 1-D rule to d dimensions, each positive-orthant
        node replicated over the 2^{d−1} sign patterns of the half space
        (first coordinate positive) at weight / 2^{d−1}, as the JAX package
        does (stpy_tpu/embeddings/fourier.py:239-271), which keeps the
        tensor-product identity exact for d > 1. Sets m = 2·(frequencies)."""
        n_signs = 2 ** (self.d - 1)
        budget = self.m // (2 * n_signs)
        self.q = max(int(np.power(budget, 1.0 / self.d)), 1)
        while (self.q + 1) ** self.d <= budget:
            self.q += 1
        nodes, weights = self.nodesAndWeights(self.q)
        if complexity_reorder:
            order = np.argsort(np.abs(nodes))
            nodes, weights = nodes[order], weights[order]
        W = cartesian([nodes] * self.d)
        wprod = np.prod(cartesian([weights] * self.d), axis=1)
        if self.d > 1:
            signs = cartesian([[1.0]] + [[-1.0, 1.0]] * (self.d - 1))
            W = (W[:, None, :] * signs[None, :, :]).reshape(-1, self.d)
            wprod = np.repeat(wprod / n_signs, n_signs)
        self.m = 2 * W.shape[0]
        self._set_frequencies(W, wprod)


class TrapezoidalEmbedding(QuadratureEmbedding):
    """Equispaced trapezoid rule in the spectral domain."""

    def nodesAndWeights(self, q):
        prob = self.transform()
        h = np.sqrt(np.pi / q) / self.gamma**2
        nodes = np.linspace(-(q // 2), q // 2, q) * h
        weights = h * prob(nodes.reshape(-1, 1)) * (2 / np.pi)
        return nodes, weights


class ClenshawCurtisEmbedding(QuadratureEmbedding):
    """Clenshaw-Curtis nodes through the cot transform."""

    def nodesAndWeights(self, q):
        L = 1.0 / self.gamma
        prob = self.transform()
        t = np.pi * np.linspace(0, q + 1, q + 2)[1:-1] / (q + 2)
        nodes = L / np.tan(t)
        weights = L * (np.pi / (q + 2)) / np.sin(t) ** 2
        weights = weights * prob(nodes.reshape(-1, 1)) * (2.0 / np.pi)
        return nodes, weights


class HermiteEmbedding(QuadratureEmbedding):
    """Gauss-Hermite quadrature Fourier features of the SE kernel."""

    def __init__(self, ones=False, cosine=False, **kwargs):
        self.ones = ones
        kwargs["cosine"] = cosine
        super().__init__(**kwargs)
        if self.kernel != "squared_exponential":
            raise AssertionError(
                "Hermite Embedding is allowed only with Squared Exponential Kernel"
            )

    def nodesAndWeights(self, q):
        nodes, weights = np.polynomial.hermite.hermgauss(2 * q)
        nodes, weights = nodes[q:], 2 * weights[q:]
        if self.ones:
            weights = np.ones(q)
        nodes = np.sqrt(2) * nodes / self.gamma
        weights = weights / np.sqrt(np.pi)
        return nodes, weights


class OverCompleteHermiteEmbedding(HermiteEmbedding):
    """The full (two-sided) Hermite rule."""

    def nodesAndWeights(self, q):
        nodes, weights = np.polynomial.hermite.hermgauss(q)
        nodes = np.sqrt(2) * nodes / self.gamma
        weights = weights / np.sqrt(np.pi)
        return nodes, weights


class MaternEmbedding(QuadratureEmbedding):
    """Hermite nodes against the Matérn or Laplace spectral density."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.kernel not in ("modified_matern", "laplace"):
            raise AssertionError(
                "Matern Embedding is allowed only with Matern Kernel"
            )

    def nodesAndWeights(self, q):
        nodes, weights = np.polynomial.hermite.hermgauss(q)
        nodes = np.sqrt(2) * nodes / self.gamma
        weights = weights / np.sqrt(np.pi)
        return nodes, weights


class QuadPeriodicEmbedding(QuadratureEmbedding):
    """A periodic lattice of frequencies."""

    def nodesAndWeights(self, q):
        weights = np.ones(q) * self.scale * 2 / (q + 1)
        om = (np.arange(q) + 1) * (np.pi / (q + 1))
        sine_scale = 1.0 / np.sin(om) ** 2
        nodes = self.scale / np.tan(om)
        prob = self.transform()
        weights = self.scale * sine_scale * weights * prob(nodes.reshape(-1, 1))
        return nodes, weights


class KLEmbedding(QuadratureEmbedding):
    """Karhunen-Loève-style expansion (the Gauss-Legendre rule)."""


class LatticeEmbedding(QuadratureEmbedding):
    """A natural-number frequency lattice."""

    def nodesAndWeights(self, q):
        nodes = np.sqrt(2) * np.arange(1, q + 1) / self.gamma
        weights = np.ones(q) / (2 * q)
        return nodes, weights
