"""Bernstein-polynomial positive bases and their spline variants.

Port of stpy_tpu/embeddings/bernstein.py: `BernsteinEmbedding`,
`BernsteinSplinesEmbedding` and `BernsteinSplinesOverlapping` (the
`basis=` options "bernstein", "splines" and "overlap-splines" of
`PoissonRateEstimator`). The (n, m) design matrix is one broadcast
expression over a binomial-coefficient table; the integrals are
Gauss-Legendre rules of high enough order to be exact for the polynomials.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

from stpy_tpu_torch.embeddings.positive import PositiveEmbedding


def _binom_table(n: int) -> np.ndarray:
    return np.array([comb(n, k) for k in range(n + 1)], dtype=float)


def _bernstein_terms(tc, C, ks, n):
    """C_k t^k (1 − t)^{n−k} for t (q, 1) in [0, 1], through logs guarded
    at the ends; entries at t = 0 are set by the caller."""
    logt = torch.log(torch.clamp(tc, min=1e-300))
    log1mt = torch.log(torch.clamp(1.0 - tc, min=1e-300))
    return C * torch.exp(ks * logt + (n - ks) * log1mt)


class BernsteinEmbedding(PositiveEmbedding):
    """Degree-(m−1) Bernstein basis on the interval."""

    def _bernstein_1d(self, x1d: torch.Tensor) -> torch.Tensor:
        lo, hi = self.interval
        t = (x1d - lo) / (hi - lo)
        inside = (t >= 0.0) & (t <= 1.0)
        tc = torch.clamp(t, 0.0, 1.0)[:, None]
        n = self.m - 1
        ks = torch.arange(self.m, dtype=self.dtype, device=self.device)
        C = self._tensor(_binom_table(n))
        B = _bernstein_terms(tc, C, ks, n)
        one, zero = torch.ones_like(B), torch.zeros_like(B)
        B = torch.where(tc == 0.0, torch.where(ks == 0, one, zero), B)
        B = torch.where(tc == 1.0, torch.where(ks == n, one, zero), B)
        return torch.where(inside[:, None], B, zero)

    def _basis_matrix_1d(self, x1d):
        return self._bernstein_1d(x1d)

    def basis_fun(self, x, j):
        x = self._tensor(x).reshape(-1)
        return self._bernstein_1d(x)[:, j].reshape(-1, 1)

    def _gl_integral_1d(self, a, b) -> torch.Tensor:
        """Exact ∫_a^b B_j for all j: the Gauss-Legendre rule of order m on
        [a, b] clipped to the interval."""
        lo, hi = self.interval
        a, b = max(float(a), lo), min(float(b), hi)
        if b <= a:
            return torch.zeros(self.m, dtype=self.dtype, device=self.device)
        nodes, weights = np.polynomial.legendre.leggauss(self.m)
        xs = self._tensor(nodes * (b - a) / 2 + (a + b) / 2)
        ws = self._tensor(weights * (b - a) / 2)
        return ws @ self._bernstein_1d(xs)

    def integral(self, S):
        key = id(S)
        if key in self.procomp_integrals:
            return self.procomp_integrals[key]
        assert S.d == self.d
        bnd = S._bounds_np
        psi = self._gl_integral_1d(bnd[0, 0], bnd[0, 1])
        for k in range(1, self.d):
            vk = self._gl_integral_1d(bnd[k, 0], bnd[k, 1])
            psi = (psi[:, None] * vk[None, :]).reshape(-1)
        emb = psi @ self.cov()
        self.procomp_integrals[key] = emb
        return emb

    def product_integral(self, S):
        """Ψ_ij = ∫_S B_i B_j, exact by the Gauss-Legendre rule of order
        m + 1, in the Γ^{1/2} basis."""
        assert self.d == 1
        lo, hi = self.interval
        a = max(float(S._bounds_np[0, 0]), lo)
        b = min(float(S._bounds_np[0, 1]), hi)
        nodes, weights = np.polynomial.legendre.leggauss(self.m + 1)
        xs = self._tensor(nodes * (b - a) / 2 + (a + b) / 2)
        ws = self._tensor(weights * (b - a) / 2)
        B = self._bernstein_1d(xs)
        Psi = (B * ws[:, None]).T @ B
        G = self.cov()
        return G.T @ Psi @ G


class _SplineMixin:
    """Piecewise-Bernstein splines: m = segments × degree local functions."""

    def _seg_params(self):
        deg = self.degree
        n_seg = self.m // deg
        dm = (self.interval[1] - self.interval[0]) / n_seg
        return deg, n_seg, dm

    def _spline_matrix_1d(self, x1d: torch.Tensor) -> torch.Tensor:
        deg, n_seg, dm = self._seg_params()
        lo = self.interval[0]
        n = deg - 1
        C = self._tensor(_binom_table(n))
        ks = torch.arange(deg, dtype=self.dtype, device=self.device)
        cols = []
        for j in range(n_seg):
            t = (x1d - (lo + j * dm)) / dm
            inside = (t >= 0.0) & (t < 1.0)
            tc = torch.clamp(t, 0.0, 1.0)[:, None]
            B = _bernstein_terms(tc, C, ks, n)
            zero = torch.zeros_like(B)
            B = torch.where(tc == 0.0,
                            torch.where(ks == 0, torch.ones_like(B), zero), B)
            cols.append(torch.where(inside[:, None], B, zero))
        return torch.cat(cols, dim=1)

    def _basis_matrix_1d(self, x1d):
        return self._spline_matrix_1d(x1d)

    def basis_fun(self, x, q):
        x = self._tensor(x).reshape(-1)
        return self._spline_matrix_1d(x)[:, q].reshape(-1, 1)

    def integral(self, S):
        assert self.d == 1
        deg, n_seg, dm = self._seg_params()
        a, b = float(S._bounds_np[0, 0]), float(S._bounds_np[0, 1])
        lo = self.interval[0]
        nodes, weights = np.polynomial.legendre.leggauss(deg + 1)
        out = []
        for j in range(n_seg):
            sa, sb = max(a, lo + j * dm), min(b, lo + (j + 1) * dm)
            if sb <= sa:
                out.append(torch.zeros(deg, dtype=self.dtype,
                                       device=self.device))
                continue
            xs = self._tensor(nodes * (sb - sa) / 2 + (sa + sb) / 2)
            ws = self._tensor(weights * (sb - sa) / 2)
            seg = self._spline_matrix_1d(xs)[:, j * deg:(j + 1) * deg]
            out.append(ws @ seg)
        return torch.cat(out) @ self.cov()


class BernsteinSplinesEmbedding(_SplineMixin, PositiveEmbedding):
    """Non-overlapping piecewise-Bernstein splines."""

    def __init__(self, *args, degree=4, **kwargs):
        super().__init__(*args, **kwargs)
        self.degree = degree
        assert self.m % degree == 0, "m must be divisible by degree"


class BernsteinSplinesOverlapping(_SplineMixin, PositiveEmbedding):
    """Overlapping spline segments (half-degree pieces on a staggered
    grid)."""

    def __init__(self, *args, degree=4, **kwargs):
        super().__init__(*args, **kwargs)
        self.degree = degree // 2
        assert self.m % self.degree == 0
