"""Nyström feature maps: data-dependent finite bases from the eigenpairs of
a landmark Gram, the landmarks chosen uniformly, by ridge leverage scores
or online; also the full-SVD, identity, cover and positive (NMF) bases.

Port of stpy_tpu/embeddings/nystrom.py (`nmf_multiplicative`,
`NystromFeatures`, and the positive subclasses
`PositiveNystromEmbeddingBump` and `OptimalPositiveBasis`). The Grams are
the kernel's (csrc/gram.cu on the card, per atom, summed in place); the
rest is torch.linalg and plain products.
Random draws come from a `torch.Generator` (`generator=`, default seeded
17 as the JAX package's PRNGKey(17)); the JAX package's draws cannot be
reproduced here, so `convert.load_nystrom_state` carries a fitted state
across.

One departure: every eigendecomposition (the landmark Gram's, "svd"'s, and
`linalg.symsqrt` for "cover") runs in float64 whatever the kernel's dtype.
cuSOLVER's f32 eigh left a 512 × 512 basis orthonormal only to 2.6e-4 on
an H100 (ROADMAP Queue 3); in float64 the basis is orthonormal to ~1e-15.
The landmark map W = D_w V diag(D^{-½}) is formed in float64 from it (the
reference's cut: eigenvalues ≤ 1e-14 get weight 0) and rounded once to
the kernel's dtype. `eigs` keeps the eigenvalues in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.embeddings.base import Embedding
from stpy_tpu_torch.embeddings.positive import PositiveEmbedding
from stpy_tpu_torch.linalg import cho_solve, safe_cholesky, symsqrt
from stpy_tpu_torch.utils.checkpoint import load_pytree, save_pytree

# the landmark eigenvalue cut of stpy_tpu/embeddings/nystrom.py:142
EIG_CUT = 1e-14


def nmf_multiplicative(X, r, iters=2000, generator=None, eps=1e-12):
    """Nonnegative factorisation X ≈ W H by Lee–Seung multiplicative
    updates; X (n, s) nonnegative, the start uniforms + 0.1 drawn from
    `generator` (default seeded 0)."""
    n, s = X.shape
    g = generator or torch.Generator().manual_seed(0)
    W = torch.rand((n, r), generator=g, dtype=X.dtype,
                   device=g.device).to(X.device) + 0.1
    H = torch.rand((r, s), generator=g, dtype=X.dtype,
                   device=g.device).to(X.device) + 0.1
    for _ in range(iters):
        H = H * (W.T @ X) / (W.T @ W @ H + eps)
        W = W * (X @ H.T) / (W @ (H @ H.T) + eps)
    return W, H


def _choice(generator, n, k, p=None):
    """k distinct indices of range(n), uniformly or with probabilities p
    (jax.random.choice(…, replace=False) in the JAX package)."""
    if p is None:
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:k]
    return torch.multinomial(p.to(generator.device), k, replacement=False,
                             generator=generator)


def _interp_columns(q, xp, fp):
    """Piecewise-linear interpolation of every column of fp (N, k) at q
    (t,), xp (N,) ascending; constant beyond the ends (jnp.interp)."""
    i = torch.clamp(torch.searchsorted(xp, q), 1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    t = torch.clamp((q - x0) / torch.where(x1 > x0, x1 - x0,
                                           torch.ones_like(x0)), 0.0, 1.0)
    return fp[i - 1] + t[:, None] * (fp[i] - fp[i - 1])


class NystromFeatures(Embedding):
    def __init__(self, kernel_object, m=100, approx="uniform", s=1.0,
                 samples=100, generator=None):
        self.fitted = False
        self.m = int(m)
        self.ms = int(m)
        self.samples = samples
        self.kernel_object = kernel_object
        self.device, self.dtype = kernel_object.device, kernel_object.dtype
        self.approx = approx
        self.s = s
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(17))
        self._xs = self._Wmat = None

    def description(self):
        return "Nystrom\nApprox: " + self.approx

    def get_m(self):
        return self.ms

    # -- subsampling schemes ---------------------------------------------------
    def uniform_subsampling(self, x, y):
        C = _choice(self.generator, x.shape[0], self.ms).to(x.device)
        return C, torch.ones(self.ms, dtype=self.dtype, device=self.device)

    def leverage_score_subsampling(self, x, y):
        """Ridge leverage scores ℓ_j = k_jj − k_jᵀ(K + s²I)⁻¹k_j, the GP
        posterior variance at the data; landmarks drawn ∝ ℓ without
        replacement, importance weights 1/√(ms·p_j)."""
        N = x.shape[0]
        K = self.kernel_object.gram(x)
        res = safe_cholesky(K + self.s**2 * torch.eye(N, dtype=K.dtype,
                                                      device=K.device))
        V = torch.linalg.solve_triangular(res.L, K, upper=False)
        lev = torch.clamp(torch.diagonal(K) - torch.sum(V * V, dim=0),
                          min=1e-12)
        p = lev / torch.sum(lev)
        C = _choice(self.generator, N, self.ms, p).to(x.device)
        return C, 1.0 / torch.sqrt(self.ms * p[C])

    def sequential_leverage_score_subsampling(self, x, y):
        """Online variant: accept point j with probability (posterior
        variance of the points accepted so far)/k_jj, one pass; pad by
        uniform picks if underfull."""
        N = x.shape[0]
        ms = self.ms
        ko = self.kernel_object
        K_full_diag = ko.diag(x)
        chosen, weights = [0], [1.0]
        us = torch.rand((N,), generator=self.generator, dtype=torch.float64,
                        device=self.generator.device).cpu().numpy()
        for j in range(1, N):
            if len(chosen) >= ms:
                break
            xs = x[torch.as_tensor(chosen, device=x.device)]
            K = ko.gram(xs) + self.s**2 * torch.eye(
                len(chosen), dtype=x.dtype, device=x.device)
            kj = ko.cross(x[j:j + 1], xs)[0]
            sol = cho_solve(safe_cholesky(K).L, kj[:, None])[:, 0]
            var = float(K_full_diag[j] - kj @ sol)
            pj = min(max(var, 0.0) / float(K_full_diag[j]), 1.0)
            if us[j] < pj:
                chosen.append(j)
                weights.append(1.0 / max(np.sqrt(pj), 1e-6))
        while len(chosen) < ms:
            chosen.append(int(us[len(chosen)] * N) % N)
            weights.append(1.0)
        return (torch.as_tensor(chosen, device=x.device),
                as_tensor(weights, device=self.device, dtype=self.dtype))

    def subsample(self, x, y):
        if self.approx == "uniform":
            return self.uniform_subsampling(x, y)
        if self.approx == "leverage":
            return self.leverage_score_subsampling(x, y)
        if self.approx == "online_leverage":
            return self.sequential_leverage_score_subsampling(x, y)
        raise AssertionError(self.approx)

    # -- fit -------------------------------------------------------------------
    def _factor(self, emb, y):
        """(K, L, θ) of the ridge K = ΦᵀΦ + s²I, θ = K⁻¹Φᵀy."""
        K = emb.T @ emb
        K.diagonal().add_(self.s * self.s)
        L = safe_cholesky(K).L
        return K, L, cho_solve(L, emb.T @ y)

    def _landmark_map(self, xs, w):
        """W = D_w V diag(D^{-½}) from the eigenpairs (float64) of the
        weighted landmark Gram D_w K(xs, xs) D_w, eigenvalues ≤ EIG_CUT
        weighted 0; W in the kernel's dtype, the eigenvalues in float64."""
        ko = self.kernel_object
        f64 = torch.float64
        w64 = w.to(f64)
        Kl = ko.eval_params(ko.params_dict, xs, xs).to(f64)
        D, V = torch.linalg.eigh(w64[:, None] * Kl * w64[None, :])
        Dinv = torch.where(D > EIG_CUT,
                           1.0 / torch.sqrt(torch.clamp(D, min=EIG_CUT)),
                           torch.zeros_like(D))
        return (w64[:, None] * (V * Dinv[None, :])).to(self.dtype), D

    def fit_gp(self, x, y, eps=1e-14):
        x = as_tensor(x, device=self.device, dtype=self.dtype)
        y = (as_tensor(y, device=self.device, dtype=self.dtype).reshape(-1, 1)
             if y is not None else None)
        self.x, self.y = x, y
        self.N, self.d = x.shape
        ko = self.kernel_object
        self._xs = self._Wmat = None
        yfit = y if y is not None else torch.zeros_like(x[:, :1])

        if self.approx == "svd":
            self.xs = x
            D, V = torch.linalg.eigh(ko.gram(x).to(torch.float64))
            V = V[:, self.N - self.ms:]
            D = torch.clamp(D[self.N - self.ms:], min=eps)
            self.eigs = D
            self.M = (V / torch.sqrt(D)[None, :]).to(self.dtype)
            self._embed = lambda q: ko.cross(q, self.xs) @ self.M
        elif self.approx == "nothing":
            self.xs = x[: self.ms]
            self.M = torch.eye(self.ms, dtype=x.dtype, device=x.device)
            self._embed = lambda q: ko.cross(q, self.xs)
        elif self.approx == "cover":
            Khalf_inv = symsqrt(ko.gram(x), inv=True)
            self._embed = lambda q: ko.cross(q, x) @ Khalf_inv
        elif self.approx == "positive_svd":
            # a nonnegative basis: NMF of squared GP prior draws on the
            # points, interpolated linearly along the first coordinate
            from stpy_tpu_torch.models.exact_gp import GaussianProcess

            GP = GaussianProcess(kernel=ko)
            ysample = GP.sample(x, size=self.samples,
                                generator=self.generator) ** 2
            W, _ = nmf_multiplicative(ysample, self.ms,
                                      generator=self.generator)
            basis = W / (torch.linalg.vector_norm(W, dim=0) + 1e-12)[None, :]
            order = torch.argsort(x[:, 0])
            xg, bg = x[order, 0].contiguous(), basis[order]
            self._embed = lambda q: _interp_columns(
                as_tensor(q, device=self.device, dtype=self.dtype)
                .reshape(-1, self.d)[:, 0].contiguous(), xg, bg)
        else:
            C, w = self.subsample(x, y)
            xs = x[C]
            Wmat, self.eigs = self._landmark_map(xs, w)
            emb = ko.eval_params(ko.params_dict, x, xs) @ Wmat   # (N, ms)
            self.K, self._L, self._theta = self._factor(emb, yfit)
            self._xs, self._Wmat = xs, Wmat
            self._embed = lambda q: ko.cross(q, xs) @ Wmat
            self.C = C
            self.Q = emb.T
            self.fitted = True
            return None

        emb = self._embed(x)
        self.Q = emb.T
        self.K, self._L, self._theta = self._factor(emb, yfit)
        self.fitted = True
        return None

    def embed(self, q):
        return self._embed(as_tensor(q, device=self.device, dtype=self.dtype))

    def mean_std(self, xtest):
        """Posterior mean Φθ and std s·√(diag Φ K⁻¹ Φᵀ) at xtest."""
        assert self.fitted, "First fit"
        emb = self.embed(xtest)
        ymean = emb @ self._theta
        temp = cho_solve(self._L, emb.T)
        diag = self.s * self.s * torch.sum(emb * temp.T, dim=1)
        return ymean, torch.sqrt(torch.clamp(diag, min=0.0))[:, None]

    def outer_kernel(self):
        emb = self.embed(self.x)
        return emb @ emb.T + self.s**2 * torch.eye(self.N, dtype=emb.dtype,
                                                   device=emb.device)

    def sample_theta(self, size=1, generator=None):
        """θ draws: the posterior N(θ̂, s²K⁻¹) after a fit, standard normals
        before; z from `generator` (torch's default where None)."""
        where = self.device if generator is None else generator.device
        z = torch.randn((self.ms, size), generator=generator,
                        dtype=self.dtype, device=where).to(self.device)
        if not self.fitted:
            return z
        Linv_z = torch.linalg.solve_triangular(self._L.T, z, upper=True)
        return self._theta + self.s * Linv_z


class PositiveNystromEmbeddingBump(PositiveEmbedding):
    """Nonnegative data-optimal basis: `NystromFeatures(approx=
    "positive_svd")` fitted on 256 grid points of the interval
    (stpy_tpu/embeddings/nystrom.py:295-323). The prior draws and the NMF
    start come from `generator` (`NystromFeatures`' default where None)."""

    def __init__(self, *args, samples=300, generator=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.samples = max(samples, self.m)
        xgrid = self.borel_set.return_discretization(256)
        self.GP = NystromFeatures(self.kernel_object, m=self.m,
                                  approx="positive_svd", samples=self.samples,
                                  generator=generator)
        self.GP.fit_gp(xgrid, xgrid[:, :1] * 0)

    def basis_fun(self, x, j):
        return self.GP.embed(self._tensor(x).reshape(-1, 1))[:, j].reshape(-1, 1)

    def _basis_matrix_1d(self, x1d):
        return self.GP.embed(x1d.reshape(-1, 1))

    def get_constraints(self):
        s = self.m**self.d
        l = torch.zeros(s, dtype=self.dtype, device=self.device)
        u = torch.full((s,), 1e10, dtype=self.dtype, device=self.device)
        return (l, torch.eye(s, dtype=self.dtype, device=self.device), u)


class OptimalPositiveBasis(PositiveNystromEmbeddingBump):
    """Data-optimal positive basis with disk save and load of the learned
    basis: its grid and the basis functions' values there, in the
    checkpoint layout of utils/checkpoint.py (the JAX package's, so a
    basis saved by either package loads in the other)."""

    def save_embedding(self, path):
        xg = self.GP.x
        save_pytree(path, {"grid": xg, "basis": self.GP.embed(xg)})

    def load_embedding(self, path):
        """Replace the basis by the saved one, interpolated linearly along
        the first coordinate between the saved grid's points; Γ is
        recomputed on the next use."""
        dat = load_pytree(path, device=self.device)
        xg = dat["grid"].to(self.dtype)
        basis = dat["basis"].to(self.dtype)
        order = torch.argsort(xg[:, 0])
        xg_s, basis_s = xg[order, 0].contiguous(), basis[order]
        self.GP._embed = lambda q: _interp_columns(
            as_tensor(q, device=self.device, dtype=self.dtype)
            .reshape(-1, self.d)[:, 0].contiguous(), xg_s, basis_s)
        self.precomp = False
        return self
