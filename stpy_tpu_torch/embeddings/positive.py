"""Pointwise-positive bases: embeddings whose coefficients can be box-
constrained to give provably nonnegative rate functions l ≤ Λθ ≤ u.

Port of stpy_tpu/embeddings/positive.py: `PositiveEmbedding` (the RKHS
re-weighting Γ^{1/2}, the tensor-product basis over d dimensions, the
constrained fit), `TriangleEmbedding` (closed-form box integrals and
product integrals), `FaberSchauderEmbedding`, `KuhnExponentialEmbedding`,
`BumpsEmbedding` and `CustomHaarBumps`. Each basis takes an explicit
``device`` (None: the card) and ``dtype``.

`cov()` builds Γ^{1/2} = M^{1/2}(Γ + 1e-5 s² I)^{1/2}, M = (ZᵀZ + sI)⁺, and
its pseudo-inverse from the kernel's Gram Γ on the m^d grid nodes. The
chain pinv → symsqrt → product runs on a Gram whose condition number is
about 1e12: the JAX package computes it on the host in float64, because in
f32 it moved benchmarks/run_all.py config 4's MAP total by more than 10 %.
The port computes the same decompositions in float64 on the embedding's
device (`torch.linalg.pinv` with numpy's cut, `linalg.symsqrt`) and rounds
only the two results to the embedding's dtype.

One departure: the JAX package feeds that chain its default-dtype Gram,
f32 outside x64. At 1024 functions (32² nodes, SE γ = 0.1) the f32
Gram's rounding, clipped at the chain's 1e-12 eigenvalue floor, raised
Γ^{1/2}'s condition number from 7.4e3 to 3.5e6 and put the f32 MAP total
34 % off float64's. A kernel narrower than float64 here gives the chain
its double-float Gram (csrc/gram_df.cu on the card) of the float64 nodes;
the f32 total then lies 2.4e-5 from float64's (tools/poisson_f32_gap.py
prints both).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stpy_tpu_torch.domains import BorelSet
from stpy_tpu_torch.embeddings.base import Embedding
from stpy_tpu_torch.kernels.df_plan import df_atom_desc, df_gram_from_desc
from stpy_tpu_torch.linalg import symsqrt
from stpy_tpu_torch.opt.prox import fista_backtracking
from stpy_tpu_torch.utils.helper import cartesian

# numpy.linalg.pinv's default cut (rcond), which the JAX package's host
# chain uses
PINV_RTOL = 1e-15


def pinv64(A):
    """Pseudo-inverse of a float64 matrix with numpy's default cut."""
    return torch.linalg.pinv(A, rtol=PINV_RTOL)


class PositiveEmbedding(Embedding):
    def __init__(self, d, m, kernel_object=None, interval=(-1, 1), B=1000.0,
                 b=0.0, s=0.001, offset=0.0, device=None, dtype=torch.float32):
        self.d = int(d)
        self.m = int(m)
        self.b = b
        self.B = B
        self.s = s
        self.offset = offset
        self.interval = (interval[0] - offset, interval[1] + offset)
        self.kernel_object = kernel_object
        self._place(device, dtype)
        self.borel_set = BorelSet(
            1, np.array([[self.interval[0], self.interval[1]]]),
            device=self.device, dtype=self.dtype)
        self.mu = None
        self.precomp = False
        self.procomp_integrals = {}

    # -- basis ----------------------------------------------------------------
    def basis_fun(self, x, j):
        """φ_j over 1-D inputs; subclasses implement."""
        raise NotImplementedError

    def _basis_matrix_1d(self, x1d: torch.Tensor) -> torch.Tensor:
        """(n, m) matrix of all 1-D basis functions; the default stacks
        basis_fun, subclasses override with a vectorized form."""
        cols = [self.basis_fun(x1d.reshape(-1, 1), j).reshape(-1)
                for j in range(self.m)]
        return torch.stack(cols, dim=1)

    def embed_internal(self, x) -> torch.Tensor:
        """Tensor-product basis over d dims (index j = j_1·m^{d-1} + … +
        j_d), as stpy_tpu/embeddings/positive.py:embed_internal."""
        x = self._tensor(x).reshape(-1, self.d)
        n = x.shape[0]
        out = self._basis_matrix_1d(x[:, 0])
        for k in range(1, self.d):
            nxt = self._basis_matrix_1d(x[:, k])
            out = (out[:, :, None] * nxt[:, None, :]).reshape(n, -1)
        return out

    def get_m(self) -> int:
        return self.m**self.d

    def get_size(self):
        return self.get_m()

    def get_constraints(self):
        s = self.get_m()
        l = torch.full((s,), float(self.b), dtype=self.dtype, device=self.device)
        u = torch.full((s,), float(self.B), dtype=self.dtype, device=self.device)
        Lambda = torch.eye(s, dtype=self.dtype, device=self.device)
        return (l, Lambda, u)

    # -- RKHS re-weighting ------------------------------------------------------
    def grid_nodes64(self) -> torch.Tensor:
        """The m^d grid nodes, (m^d, d) in float64."""
        dm = (self.interval[1] - self.interval[0]) / (self.m - 1)
        t = self.interval[0] + np.arange(self.m) * dm
        return torch.tensor(cartesian([t] * self.d), dtype=torch.float64,
                            device=self.device)

    def _grid_nodes(self) -> torch.Tensor:
        return self._tensor(self.grid_nodes64())

    def _grid_gram64(self):
        """The kernel's Gram on the grid nodes in float64: for a kernel
        narrower than float64, the double-float Gram of the float64 nodes
        (csrc/gram_df.cu on the card for the fused families), else the
        kernel's own Gram."""
        ko = self.kernel_object
        t64 = self.grid_nodes64()
        if ko.dtype != torch.float64:
            Kh, Kl = df_gram_from_desc(ko, ko.params_dict, t64, t64,
                                       df_atom_desc(ko))
            K = Kh.double() + Kl.double()
            return 0.5 * (K + K.T)
        return ko.gram(t64).double()

    def cov(self, inverse=False):
        if not self.precomp:
            if self.kernel_object is not None:
                f64 = torch.float64
                t = self._grid_nodes()
                Gamma = self._grid_gram64().to(self.device)
                Z = self.embed_internal(t).to(f64)
                n = Gamma.shape[0]
                eye = torch.eye(n, dtype=f64, device=self.device)
                M = pinv64(Z.T @ Z + self.s * eye)
                Gh = symsqrt(M) @ symsqrt(Gamma + 1e-5 * self.s**2 * eye)
                self.Gamma_half = Gh.to(self.dtype)
                self.invGamma_half = pinv64(Gh).to(self.dtype)
            else:
                self.Gamma_half = torch.eye(self.get_m(), dtype=self.dtype,
                                            device=self.device)
                self.invGamma_half = self.Gamma_half
            self.precomp = True
        if inverse:
            return self.Gamma_half, self.invGamma_half
        return self.Gamma_half

    def embed(self, x) -> torch.Tensor:
        return self.embed_internal(x) @ self.cov()

    # -- constrained fit --------------------------------------------------------
    def fit(self, x, y, already_embedded=False):
        """min_ξ s²·‖ξ‖ + ‖Φξ − y‖² s.t. b ≤ Γ^{1/2}ξ ≤ B, solved by box
        FISTA in the θ = Γ^{1/2}ξ variable, where the constraint is a clip."""
        G_half, invG_half = self.cov(inverse=True)
        Phi_raw = (self._tensor(x) @ invG_half if already_embedded
                   else self.embed_internal(x))
        yv = self._tensor(y).reshape(-1)
        l, _, u = self.get_constraints()

        def obj(theta):
            r = Phi_raw @ theta - yv
            xi = invG_half @ theta
            return torch.sum(r * r) + self.s**2 * torch.sqrt(
                torch.sum(xi * xi) + 1e-12)

        theta0 = torch.clamp(torch.zeros_like(l), l, u)
        res = fista_backtracking(obj, theta0, lambda t: torch.clamp(t, l, u),
                                 max_iter=1000)
        xi = invG_half @ res.x
        self.mode = xi[:, None]
        self.mu = self.mode
        return xi.cpu().numpy()

    def mean(self, xtest):
        return self.embed(xtest) @ self.mu

    def mean_std(self, xtest):
        return self.mean(xtest), None

    def sample_theta(self, generator=None):
        """θ ~ N(0, I) from `generator` (torch's default where None)."""
        where = self.device if generator is None else generator.device
        self.mu = torch.randn((self.get_m(), 1), generator=generator,
                              dtype=self.dtype, device=where).to(self.device)
        return self.mu

    def sample(self, xtest, size=1, generator=None):
        return self.embed(xtest) @ self.sample_theta(generator)

    def _set_bounds(self, S):
        return S.bounds.to(device=self.device, dtype=self.dtype)

    # generic integral via quadrature (closed forms in the subclasses)
    def integral(self, S):
        key = id(S)
        if key in self.procomp_integrals:
            return self.procomp_integrals[key]
        w, nodes = S.return_legendre_discretization(30)
        psi = self._tensor(w) @ self.embed_internal(nodes)
        emb = psi @ self.cov()
        self.procomp_integrals[key] = emb
        return emb


def _hat_integral_cdf(z):
    """G(z) = ∫_{-∞}^z max(1 − |t|, 0) dt, the unit hat's closed-form CDF."""
    z = torch.clamp(z, -1.0, 1.0)
    return torch.where(z <= 0.0, 0.5 * (z + 1.0) ** 2,
                       1.0 - 0.5 * (1.0 - z) ** 2)


class TriangleEmbedding(PositiveEmbedding):
    """Hat functions on a uniform grid with exact box integrals (one hat-CDF
    difference for all nodes)."""

    def _nodes_dm(self):
        dm = (self.interval[1] - self.interval[0]) / (self.m - 1)
        t = self.interval[0] + torch.arange(self.m, dtype=self.dtype,
                                            device=self.device) * dm
        return t, dm

    def basis_fun(self, x, j):
        t, dm = self._nodes_dm()
        return torch.clamp(1.0 - torch.abs((self._tensor(x) - t[j]) / dm),
                           min=0.0)

    def _basis_matrix_1d(self, x1d):
        t, dm = self._nodes_dm()
        return torch.clamp(1.0 - torch.abs((x1d[:, None] - t[None, :]) / dm),
                           min=0.0)

    def integral_1d_all(self, a, b):
        """∫_a^b hat_j for all m nodes: dm·(G((b − t)/dm) − G((a − t)/dm))."""
        t, dm = self._nodes_dm()
        return dm * (_hat_integral_cdf((b - t) / dm)
                     - _hat_integral_cdf((a - t) / dm))

    def integral(self, S):
        key = id(S)
        if key in self.procomp_integrals:
            return self.procomp_integrals[key]
        assert S.d == self.d
        if S.type == "box":
            # tensor-product box integral for any d, in embed_internal's
            # index order
            bnd = self._set_bounds(S)
            psi = self.integral_1d_all(bnd[0, 0], bnd[0, 1])
            for k in range(1, self.d):
                vk = self.integral_1d_all(bnd[k, 0], bnd[k, 1])
                psi = (psi[:, None] * vk[None, :]).reshape(-1)
        else:
            w, nodes = S.return_legendre_discretization(30)
            psi = self._tensor(w) @ self.embed_internal(nodes)
        emb = psi @ self.cov()
        self.procomp_integrals[key] = emb
        return emb

    def product_integral(self, S):
        """Ψ_ij = ∫ φ_i φ_j over the whole domain box: the tridiagonal closed
        form of overlapping hats, tensorized across dims, in the Γ^{1/2}
        basis."""
        t, dm = self._nodes_dm()
        main = torch.full((self.m,), 2.0 * dm / 3.0, dtype=self.dtype,
                          device=self.device)
        main[0] = main[-1] = dm / 3.0
        off = torch.full((self.m - 1,), dm / 6.0, dtype=self.dtype,
                         device=self.device)
        Psi1 = torch.diag(main) + torch.diag(off, 1) + torch.diag(off, -1)
        Psi = Psi1
        for _ in range(1, self.d):
            Psi = torch.kron(Psi, Psi1)
        G = self.cov()
        return G.T @ Psi @ G


class FaberSchauderEmbedding(TriangleEmbedding):
    """Hierarchical (dyadic) hat basis."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if 2 ** int(np.log2(self.m)) != self.m:
            raise AssertionError("This basis works only with log_2(n) is integer.")

    def _node_table(self):
        """(centers, widths) of the m hierarchical hats; index 0 is the
        constant function (width inf)."""
        c = np.zeros(self.m)
        w = np.zeros(self.m)
        span = self.interval[1] - self.interval[0]
        c[0], w[0] = 0.0, np.inf
        if self.m > 1:
            c[1], w[1] = 0.0, span / 2
        for j in range(2, self.m):
            level = int(np.floor(np.log2(j)))
            start = 2**level
            dm = span / (2 * start)
            c[j] = self.interval[0] + (j - start) * 2 * dm + dm
            w[j] = dm
        return c, w

    def basis_fun(self, x, j):
        x = self._tensor(x)
        c, w = self._node_table()
        if j == 0:
            return torch.ones_like(x)
        return torch.clamp(1.0 - torch.abs((x - c[j]) / w[j]), min=0.0)

    def _basis_matrix_1d(self, x1d):
        c, w = self._node_table()
        c_j = self._tensor(c)
        w_j = self._tensor(np.where(np.isinf(w), 1.0, w))
        hats = torch.clamp(
            1.0 - torch.abs((x1d[:, None] - c_j[None, :]) / w_j[None, :]),
            min=0.0)
        hats[:, 0] = 1.0
        return hats

    def integral(self, S):
        assert self.d == 1
        bnd = self._set_bounds(S)
        a, b = bnd[0, 0], bnd[0, 1]
        c, w = self._node_table()
        vals = [b - a]
        for j in range(1, self.m):
            vals.append(w[j] * (_hat_integral_cdf((b - c[j]) / w[j])
                                - _hat_integral_cdf((a - c[j]) / w[j])))
        psi = torch.stack([self._tensor(v) for v in vals])
        return psi @ self.cov()

    def hierarchical_mask(self):
        mask = [0]
        for i in range(int(np.log2(self.m))):
            mask.extend([i + 1] * (2**i))
        return self._tensor(mask)


class KuhnExponentialEmbedding(PositiveEmbedding):
    """Gaussian-RKHS covering basis of Kühn."""

    def __init__(self, *args, gamma=0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.gamma = gamma

    def basis_fun(self, x, j):
        x = self._tensor(x)
        k = math.exp(j / 2 * math.log(1.0 / self.gamma)
                     - (j / 2) * math.lgamma(j + 1))
        res = k * (x**j) * torch.exp(-(x**2) / (2 * self.gamma**2))
        return torch.where((x < 0) | (x > 1), torch.zeros_like(res), res)


class BumpsEmbedding(PositiveEmbedding):
    """Parabolic bumps on a grid."""

    def basis_fun(self, x, j):
        x = self._tensor(x)
        dm = (self.interval[1] - self.interval[0]) / (self.m - 1)
        tj = self.interval[0] + j * dm
        res = -(x - tj) * (x - (tj + 2 * dm)) / dm**2
        return torch.clamp(res, min=0.0)


class CustomHaarBumps(PositiveEmbedding):
    """Weighted indicator bumps at custom nodes and widths."""

    def __init__(self, d, m, nodes, widths, weights, **kwargs):
        super().__init__(d, m, **kwargs)
        self.nodes = self._tensor(nodes)
        self.widths = self._tensor(widths)
        self.weights_j = self._tensor(weights)

    def basis_fun(self, x, j):
        x = self._tensor(x)
        mask = torch.abs(x - self.nodes[j]) < self.widths[j]
        return torch.where(mask, self.weights_j[j], torch.zeros_like(x))


__all__ = [
    "BumpsEmbedding", "CustomHaarBumps", "FaberSchauderEmbedding",
    "KuhnExponentialEmbedding", "PositiveEmbedding", "TriangleEmbedding",
    "pinv64",
]
