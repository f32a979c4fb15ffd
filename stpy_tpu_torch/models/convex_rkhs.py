"""Locally-weighted RKHS regression with a learned feature-space metric
(shape-constrained / "convex" RKHS).

Port of stpy_tpu/models/convex_rkhs.py: per-point local ridge fits
weighted by a learned diagonal Mahalanobis similarity in feature space,
the metric fitted by L-BFGS restarts. The JAX package vmaps the n local
fits and the restarts; here the n local fits are one batched Cholesky
solve (each row's jitter scaled by its own mean diagonal, as
`chol_jittered` under vmap), and the restarts run one `minimize_lbfgs`
each, so each restart equals its own solve. The restarts' starting
points are drawn through `_normal` from a `torch.Generator`. The model
lives on its embedding's device and dtype.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import default_jitter
from stpy_tpu_torch.models.feature_gp import KernelizedFeatures
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs


def _normal(generator, shape, dtype, device):
    """Standard normals drawn in float64 and rounded to `dtype`, so that an
    f32 and a float64 model on generators seeded alike see the same draws."""
    where = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=torch.float64,
                       device=where).to(device=device, dtype=dtype)


class ConvexRKHS(KernelizedFeatures):
    def __init__(self, embedding, m, lam=0.0, s=0.01):
        super().__init__(embedding, m, s=s, lam=lam)
        self.gamma_metric = torch.ones(self.m, dtype=self.dtype,
                                       device=self.device)

    def weight_scaling(self, gamma, scale, x_single, xs, Phi_all):
        phi0 = self.embed(x_single.reshape(1, -1))
        return torch.exp(
            -torch.sum(((Phi_all - phi0) * gamma / scale) ** 2, dim=1)
        )

    def _local_fits(self, W, X):
        """θ_b = (Xᵀ D_b X + (λ + 1e-6) I)⁻¹ Xᵀ D_b y for every row b of
        the weights W, (b, m, 1), by a jittered Cholesky each."""
        m = X.shape[1]
        eye = torch.eye(m, dtype=X.dtype, device=X.device)
        XW = X[None, :, :] * W[:, :, None]                    # (b, n, m)
        A = XW.transpose(1, 2) @ X + (self.lam + 1e-6) * eye
        b = XW.transpose(1, 2) @ self.y                       # (b, m, 1)
        scale = torch.diagonal(A, dim1=1, dim2=2).mean(dim=1)
        scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
        A = A + (default_jitter(A.dtype) * scale)[:, None, None] * eye
        L, info = torch.linalg.cholesky_ex(A)
        L = torch.where((info == 0)[:, None, None], L,
                        torch.full_like(L, float("nan")))
        return torch.cholesky_solve(b, L, upper=False)

    def _local_fit(self, weights, X):
        return self._local_fits(weights[None, :], X)[0]

    def local_fit(self, weights):
        return self._local_fit(weights, self.embed(self.x))

    def fit_gp(self, x, y):
        self.x = self._tensor(x)
        self.y = self._tensor(y).reshape(-1, 1)
        self.n, self.d = self.x.shape
        self.fitted = True

    fit = fit_gp

    def optimize_params(self, restarts=5, maxiter=100, verbose=False,
                        generator=None, **kwargs):
        """Learn the diagonal feature-space metric by minimizing the
        prediction + consistency loss, all local fits batched."""
        generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(1)
        X = self.embed(self.x)
        yv = self.y
        n, m = X.shape

        def total_loss(gamma):
            W = torch.exp(
                -torch.sum(
                    ((X[:, None, :] - X[None, :, :]) * gamma) ** 2, dim=2
                )
            )  # (n, n) similarity
            thetas = self._local_fits(W, X)                 # (n, m, 1)
            preds = torch.einsum("ij,njk->nik", X, thetas)  # (n, n, 1)
            # prediction loss
            loss = torch.sum(
                (preds[:, :, 0] - yv.reshape(-1)[None, :]) ** 2
                / self.s**2 * W
            ) / 2.0
            # pairwise consistency
            diff = preds[:, None, :, 0] - preds[None, :, :, 0]
            ww = W[:, None, :] * W[None, :, :]
            loss = loss + torch.sum(diff**2 / self.s**2 * ww) / n
            return loss + 1e-3 * torch.sum(gamma**2)

        g0s = _normal(generator, (restarts, m), self.dtype, self.device) ** 2
        results = [minimize_lbfgs(total_loss, g0, max_iter=maxiter)
                   for g0 in g0s]
        values = torch.stack([r.value for r in results])
        values = torch.where(torch.isnan(values),
                             torch.full_like(values, float("inf")), values)
        best = int(torch.argmin(values))
        self.gamma_metric = torch.abs(results[best].x)
        return self.gamma_metric

    def mean_std(self, xtest):
        X = self.embed(self.x)
        Phi_t = self.embed(xtest)
        W = torch.exp(-torch.sum(
            ((X[None, :, :] - Phi_t[:, None, :]) * self.gamma_metric) ** 2,
            dim=2))
        thetas = self._local_fits(W, X)                     # (t, m, 1)
        mu = torch.einsum("tm,tmk->tk", Phi_t, thetas)
        return mu, None

    def mean(self, xtest):
        return self.mean_std(xtest)[0]
