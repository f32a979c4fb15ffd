"""Polynomial, Chebyshev, custom, one-hot and SVD-packing embeddings.

Port of stpy_tpu/embeddings/polynomial.py. Each takes an explicit
``device`` (None: the card) and ``dtype``; `PackingEmbedding` lives on its
kernel's.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.embeddings.base import Embedding
from stpy_tpu_torch.utils.helper import cartesian


def _jacobian_rows(embed, x):
    """dΦ/dx (n, m, d) of a row-wise map Φ: row i of Φ depends on x_i only,
    so the gradient of the column sums gives every row's Jacobian."""
    with torch.enable_grad():
        p = x.detach().requires_grad_()
        out = embed(p)
        rows = [torch.autograd.grad(out[:, j].sum(), p, retain_graph=True)[0]
                for j in range(out.shape[1])]
    return torch.stack(rows, dim=1)


class PolynomialEmbedding(Embedding):
    """Tensor monomials up to total degree p, with derivatives."""

    def __init__(self, d, p, groups=None, kappa=1.0, include_bias=True,
                 device=None, dtype=torch.float32):
        self._place(device, dtype)
        self.d = int(d)
        self.p = int(p)
        self.kappa = kappa
        self.groups = groups
        self.include_bias = include_bias
        degs = []
        for total in range(0 if include_bias else 1, p + 1):
            for combo in itertools.product(range(total + 1), repeat=d):
                if sum(combo) == total:
                    degs.append(combo)
        self.exponents = torch.as_tensor(np.array(degs), dtype=torch.int64,
                                         device=self.device)   # (m, d)
        self.m = self.exponents.shape[0]

    def embed(self, x):
        x = self._tensor(x).reshape(-1, self.d)
        # cumulative powers: x^E through exp/log is unstable at 0
        pows = [torch.ones_like(x)]
        for _ in range(self.p):
            pows.append(pows[-1] * x)
        P = torch.stack(pows, dim=0)  # (p+1, n, d)
        feats = torch.ones((x.shape[0], self.m), dtype=x.dtype,
                           device=x.device)
        for j in range(self.d):
            feats = feats * P[self.exponents[:, j], :, j].T
        return float(np.sqrt(self.kappa)) * feats

    def derivative_1(self, x):
        """dΦ/dx by the power rule, (n, m, d)."""
        x = self._tensor(x).reshape(-1, self.d)
        base = self.embed(x) / float(np.sqrt(self.kappa))
        out = []
        for k in range(self.d):
            ek = self.exponents[:, k].to(x.dtype)
            xk = x[:, k:k + 1]
            xk = torch.where(torch.abs(xk) < 1e-30, torch.full_like(xk, 1e-30),
                             xk)
            out.append(base * ek[None, :] / xk)
        return float(np.sqrt(self.kappa)) * torch.stack(out, dim=2)

    def get_m(self):
        return self.m


class ChebyschevEmbedding(Embedding):
    """Chebyshev polynomials T_0..T_p per dimension, tensorised."""

    def __init__(self, d, p, kappa=1.0, device=None, dtype=torch.float32):
        self._place(device, dtype)
        self.d = int(d)
        self.p = int(p)
        self.kappa = kappa
        self.m = (p + 1) ** d

    def _cheb_1d(self, t):
        Ts = [torch.ones_like(t), t]
        for _ in range(2, self.p + 1):
            Ts.append(2 * t * Ts[-1] - Ts[-2])
        return torch.stack(Ts[: self.p + 1], dim=1)  # (n, p+1)

    def embed(self, x):
        x = self._tensor(x).reshape(-1, self.d)
        n = x.shape[0]
        out = self._cheb_1d(x[:, 0])
        for k in range(1, self.d):
            nxt = self._cheb_1d(x[:, k])
            out = torch.einsum("ni,nj->nij", out, nxt).reshape(n, -1)
        return float(np.sqrt(self.kappa)) * out

    def get_m(self):
        return self.m


class CustomEmbedding(Embedding):
    """An arbitrary feature map fn(x) -> (n, m); `integral(S)` by S's
    Gauss-Legendre discretisation (`S.return_legendre_discretization`)."""

    def __init__(self, d, fn, m, quadrature_order=30, kappa=1.0, device=None,
                 dtype=torch.float32):
        self._place(device, dtype)
        self.d = int(d)
        self.fn = fn
        self.m = int(m)
        self.kappa = kappa
        self.quadrature_order = quadrature_order

    def embed(self, x):
        return float(np.sqrt(self.kappa)) * self.fn(
            self._tensor(x).reshape(-1, self.d))

    def integral(self, S):
        w, nodes = S.return_legendre_discretization(self.quadrature_order)
        return self._tensor(w) @ self.embed(nodes)

    def get_m(self):
        return self.m


class OnehotEmbedding(Embedding):
    """Categorical one-hot features."""

    def __init__(self, d, cats, device=None, dtype=torch.float32):
        self._place(device, dtype)
        self.d = int(d)
        self.cats = int(cats)
        self.m = self.d * self.cats

    def embed(self, x):
        x = as_tensor(x, device=self.device, dtype=torch.float64).to(
            torch.int64).reshape(-1, self.d)
        eye = torch.eye(self.cats, dtype=self.dtype, device=self.device)
        return eye[x].reshape(x.shape[0], -1)

    def get_m(self):
        return self.m


class PackingEmbedding(Embedding):
    """SVD-packing basis: an orthonormal basis of the span of kernel
    columns on a packing grid; derivatives by autograd. The grid Gram's
    eigh runs in float64 (see `linalg.symsqrt`)."""

    def __init__(self, d, m, kernel_object, interval=(-1, 1), grid=64):
        self.device, self.dtype = kernel_object.device, kernel_object.dtype
        self.d = int(d)
        self.m = int(m)
        self.kernel_object = kernel_object
        per = max(int(round(grid ** (1.0 / d))), 2)
        xs = [np.linspace(interval[0], interval[1], per) for _ in range(d)]
        self.grid = self._tensor(cartesian(xs))
        K = kernel_object.gram(self.grid)
        w, V = torch.linalg.eigh(K.to(torch.float64))
        w = torch.clamp(torch.flip(w, [0])[: self.m], min=1e-12)
        V = torch.flip(V, [1])[:, : self.m]
        self._M = (V / torch.sqrt(w)[None, :]).to(self.dtype)

    def embed(self, x):
        return self.kernel_object.cross(
            self._tensor(x).reshape(-1, self.d), self.grid) @ self._M

    def derivative_1(self, x):
        return _jacobian_rows(self.embed, self._tensor(x).reshape(-1, self.d))

    def get_m(self):
        return self.m
