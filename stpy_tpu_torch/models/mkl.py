"""Multiple-kernel learning.

Port of stpy_tpu/models/mkl.py: `MultipleKernelLearner` (kernel-space MKL,
weights on the simplex by exponentiated gradient on yᵀ(Σ αₖKₖ + λs²I)⁻¹y
plus a simplex regularizer), `MKL` (group-lasso MKL on concatenated
embeddings, FISTA with the group soft threshold) and `PrimalMKL`.

The Grams are the kernels' own (`KernelFunction.gram` / `cross`: the hand
Gram kernels csrc/gram.cu and csrc/gram_l1.cu on the card). Where the JAX
package differentiates the objective through the Cholesky with
`jax.grad`, the port hands `minimize_on_simplex` the closed form: with
β = A_j⁻¹y, A_j = A + j·mean(diag A)·I the jittered system that
`chol_jittered` factors, ∂/∂αₖ = −βᵀKₖβ − j·mean(diag Kₖ)·βᵀβ, plus the
regularizer's gradient by autograd; one Cholesky a step, where the JAX
scan also re-evaluates the objective after every step. The learner lives
in `dtype` on `device` (the card unless the caller passes another), as
its kernels must.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, default_jitter, resolve_device
from stpy_tpu_torch.linalg import (
    chol_jittered,
    cho_solve,
    safe_cholesky,
    tri_solve_blocked,
)
from stpy_tpu_torch.models.estimator import Estimator
from stpy_tpu_torch.opt.frank_wolfe import minimize_on_simplex
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs
from stpy_tpu_torch.opt.prox import fista_prox_backtracking, prox_group_l2


def _mix(alpha, Ks):
    return torch.einsum("k,kij->ij", alpha, Ks)


class MultipleKernelLearner(Estimator):
    def __init__(self, kernel_objects, lam=1.0, s=0.01, opt="closed",
                 regularizer=None, device=None, dtype=torch.float32):
        self.kernel_objects = kernel_objects
        self.no_models = len(kernel_objects)
        self.regularizer = regularizer
        self.s = s
        self.lam = lam
        self.opt = opt
        self.var = "fixed"
        self.fitted = False
        self.x = None
        self.y = None
        self.device, self.dtype = resolve_device(device), dtype

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _eye(self, n):
        return torch.eye(n, dtype=self.dtype, device=self.device)

    def fit(self):
        self.fit_gp(self.x, self.y)

    def objective(self, alpha):
        """yᵀ(Σ αₖKₖ + λs²I)⁻¹y (+ the regularizer) by a jittered
        Cholesky, on the Grams of the last `fit_gp`."""
        A = _mix(alpha, self.Ks) + self.lam * self.s**2 * self._eye(self.n)
        val = (self.y.T @ cho_solve(chol_jittered(A), self.y))[0, 0]
        if self.regularizer is not None:
            val = val + self.regularizer.eval(alpha)
        return val

    def objective_grad(self, alpha):
        """The objective's gradient in α in closed form (the regularizer's
        part by autograd)."""
        A = _mix(alpha, self.Ks) + self.lam * self.s**2 * self._eye(self.n)
        j = default_jitter(A.dtype)
        beta = cho_solve(chol_jittered(A), self.y)[:, 0]
        quad = torch.einsum("i,kij,j->k", beta, self.Ks, beta)
        diag_means = torch.diagonal(self.Ks, dim1=1, dim2=2).mean(dim=1)
        # chol_jittered scales its jitter by mean(diag A) where that is > 0
        scale_live = (torch.mean(torch.diagonal(A)) > 0).to(A.dtype)
        g = -quad - j * diag_means * (beta @ beta) * scale_live
        if self.regularizer is not None:
            with torch.enable_grad():
                a = alpha.detach().requires_grad_()
                (gr,) = torch.autograd.grad(self.regularizer.eval(a), a)
            g = g + gr
        return g

    def fit_gp(self, x, y, steps=300):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.x, self.y = x, y
        self.n, self.d = x.shape
        self.Ks = torch.stack([k.gram(x) for k in self.kernel_objects], dim=0)
        alpha0 = torch.ones(self.no_models, dtype=self.dtype,
                            device=self.device) / self.no_models
        alphas, _ = minimize_on_simplex(self.objective, alpha0, steps=steps,
                                        eta=0.05, grad=self.objective_grad)
        self.alphas = alphas
        self.K = _mix(alphas, self.Ks) + self.lam * self.s**2 * self._eye(self.n)
        res = safe_cholesky(self.K)
        self.L = res.L
        self.A = cho_solve(res.L, y)
        self.fitted = True

    def _cross(self, xtest):
        return _mix(self.alphas, torch.stack(
            [k.cross(xtest, self.x) for k in self.kernel_objects], dim=0))

    def execute(self, xtest):
        xtest = self._tensor(xtest)
        K_star = self._cross(xtest) if self.fitted else None
        K_ss = _mix(self.alphas, torch.stack(
            [k.gram(xtest) for k in self.kernel_objects], dim=0))
        return K_star, K_ss

    def mean(self, xtest):
        return self._cross(self._tensor(xtest)) @ self.A

    def mean_std(self, xtest, full=False, reuse=False):
        xtest = self._tensor(xtest)
        K_star = self._cross(xtest)
        mu = K_star @ self.A
        V = tri_solve_blocked(self.L, K_star.T)
        diag = _mix(self.alphas, torch.stack(
            [k.diag(xtest) for k in self.kernel_objects], dim=0)[:, :, None]
        )[:, 0]
        var = torch.clamp(diag - torch.sum(V * V, dim=0), min=1e-30)
        if full:
            Kss = self.execute(xtest)[1]
            return mu, Kss - V.T @ V
        return mu, torch.sqrt(var)[:, None]

    def ucb(self, xtest):
        mu, s = self.mean_std(xtest)
        return mu + 2 * s

    def lcb(self, xtest):
        mu, s = self.mean_std(xtest)
        return mu - 2 * s


class MKL(Estimator):
    """Feature-space MKL: group-lasso over concatenated embeddings. Fit =
    FISTA with the group soft-threshold prox. The model lives on its
    embeddings' device and dtype."""

    def __init__(self, embeddings, init_weights=None, lam=0.0, s=0.1):
        self.embeddings = embeddings
        self.no_models = len(embeddings)
        self.device, self.dtype = embeddings[0].device, embeddings[0].dtype
        self.s = s
        self.lam = lam if isinstance(lam, list) else [
            lam for _ in range(self.no_models)
        ]
        self.init_weights = (
            init_weights
            if init_weights is not None
            else torch.ones(self.no_models, dtype=self.dtype,
                            device=self.device)
        )
        self.weights = self.init_weights
        self.x = None
        self.y = None
        self.theta = None

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def get_embed_dims(self):
        return [int(e.get_m()) for e in self.embeddings]

    get_emebed_dims = get_embed_dims  # reference typo alias

    def total_embed_dim(self):
        return int(np.sum(self.get_embed_dims()))

    def embed(self, x):
        x = self._tensor(x)
        return torch.cat([e.embed(x) for e in self.embeddings], dim=1)

    def _groups(self):
        dims = self.get_embed_dims()
        offs = np.concatenate([[0], np.cumsum(dims)]).astype(int)
        return [list(range(offs[i], offs[i + 1])) for i in range(len(dims))]

    def fit_gp(self, x, y):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.x, self.y = x, y
        self.n, self.d = x.shape
        Q = self.embed(x)
        groups = self._groups()
        lam = self.lam
        yv = y.reshape(-1)

        def smooth(theta):
            r = Q @ theta - yv
            return 0.5 * torch.sum(r * r) / self.s**2

        def prox(theta, step):
            out = theta
            for i, g in enumerate(groups):
                out = prox_group_l2(out, step * lam[i], [g])
            return out

        res = fista_prox_backtracking(
            smooth, torch.zeros(Q.shape[1], dtype=Q.dtype, device=Q.device),
            prox, max_iter=1000,
        )
        self.theta = res.x[:, None]
        # effective per-model weights = group norms
        self.weights = torch.stack([
            torch.linalg.vector_norm(res.x[g[0]:g[-1] + 1]) for g in groups])
        return self.theta

    fit = fit_gp

    def mean_vector(self):
        return self.theta

    def mean_var(self, xtest):
        Phi = self.embed(xtest)
        mu = Phi @ self.theta
        return mu, None

    def mean_std(self, xtest):
        return self.mean_var(xtest)

    def sample(self, xtest, size=1, generator=None):
        mu, _ = self.mean_var(xtest)
        return mu.repeat(1, size)

    def ucb(self, xtest):
        return self.mean_var(xtest)[0]

    def lcb(self, xtest):
        return self.mean_var(xtest)[0]


class PrimalMKL(MKL):
    """Primal MKL with explicit per-model scale variables: alternating
    (theta | weights) minimization of ||Σ_k w_k Φ_k θ_k - y||²/2s²
    + Σ λ_k ||θ_k||², weights on the simplex."""

    def fit_gp(self, x, y, outer_steps=10):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.x, self.y = x, y
        self.n, self.d = x.shape
        Phis = [e.embed(x) for e in self.embeddings]
        yv = y.reshape(-1)
        lam = self.lam
        thetas = [torch.zeros(p.shape[1], dtype=p.dtype, device=p.device)
                  for p in Phis]
        w = torch.ones(self.no_models, dtype=self.dtype,
                       device=self.device) / self.no_models
        sizes = [p.shape[1] for p in Phis]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

        for _ in range(outer_steps):
            # theta step (joint, smooth)
            def obj_theta(flat, w=w):
                pred = 0.0
                regv = 0.0
                for k in range(self.no_models):
                    tk = flat[offs[k] : offs[k + 1]]
                    pred = pred + w[k] * (Phis[k] @ tk)
                    regv = regv + lam[k] * torch.sum(tk * tk)
                r = pred - yv
                return 0.5 * torch.sum(r * r) / self.s**2 + regv

            flat = minimize_lbfgs(obj_theta, torch.cat(thetas), max_iter=200).x
            thetas = [
                flat[offs[k] : offs[k + 1]] for k in range(self.no_models)
            ]

            # weight step on the simplex
            preds = torch.stack(
                [Phis[k] @ thetas[k] for k in range(self.no_models)], dim=1
            )

            def obj_w(wv, preds=preds):
                r = preds @ wv - yv
                return 0.5 * torch.sum(r * r) / self.s**2

            w, _ = minimize_on_simplex(obj_w, w, steps=100, eta=0.1)

        self.thetas = thetas
        self.weights = w
        self.theta = torch.cat(
            [w[k] * thetas[k] for k in range(self.no_models)]
        )[:, None]
        return self.theta
