"""Mixture estimators: model-averaged GPs with random kernel weights.

Port of stpy_tpu/models/mixtures.py: `DirichletMixture` and
`CategoricalMixture`. Each posterior draw mixes the component Grams with
random weights and samples the mixed GP's posterior. The weights and the
normals come from a `torch.Generator` through the draw helpers
`_dirichlet` (normalised gammas by Marsaglia and Tsang's method),
`_categorical` and `_normal`. A `sample` call forms the test points'
cross and test Grams once for all its draws, where the JAX package forms
them in every draw. Each draw factors the mixed posterior's moments in
float64 on float64 Grams (an f32 model's double-float Grams, csrc/gram_df.cu
on the card), as `GaussianProcess.sample` does: in f32, and on f32 Grams
promoted, the posterior covariance at 256 test points among 2048 data
points is indefinite past the jitter ladder (chip_smoke.py phase 19.4 on
the CPU), and the JAX package's f32 draws there are NaN. The mixture lives in `dtype` on `device` (the card unless the
caller passes another), as its processes must.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.kernels.df_plan import gram64
from stpy_tpu_torch.linalg import cho_solve, safe_cholesky, tri_solve
from stpy_tpu_torch.models.estimator import Estimator


def _on(generator, device):
    return device if generator is None else generator.device


def _normal(generator, shape, dtype, device):
    """Standard normals drawn in float64 and rounded to `dtype`, so that an
    f32 and a float64 model on generators seeded alike see the same draws."""
    where = device if generator is None else generator.device
    return torch.randn(shape, generator=generator, dtype=torch.float64,
                       device=where).to(device=device, dtype=dtype)


def _gamma(generator, alpha):
    """Gamma(α, 1) draws, one per entry of α (float64), by Marsaglia and
    Tsang's squeeze method; α < 1 through Gamma(α + 1)·U^{1/α}."""
    boost = alpha < 1.0
    a = torch.where(boost, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        z = _normal(generator, a.shape, a.dtype, a.device)
        u = _uniform(generator, a)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-300)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = _uniform(generator, a)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def _uniform(generator, like):
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=_on(generator, like.device)).to(like.device)


def _dirichlet(generator, concentration):
    """One Dirichlet(concentration) draw, in concentration's dtype."""
    g = _gamma(generator, concentration.to(torch.float64))
    return (g / torch.sum(g)).to(concentration.dtype)


def _categorical(generator, logits):
    """One index drawn with probabilities softmax(logits)."""
    p = torch.softmax(logits.to(torch.float64), dim=0)
    return int(torch.multinomial(p.to(_on(generator, p.device)), 1,
                                 generator=generator)[0])


class DirichletMixture(Estimator):
    def __init__(self, processes, concentration=None, generator=None,
                 device=None, dtype=torch.float32):
        self.processes = processes  # list of GaussianProcess-like objects
        self.k = len(processes)
        self.s = processes[0].s
        self.device, self.dtype = resolve_device(device), dtype
        self.concentration = (
            concentration
            if concentration is not None
            else np.ones(self.k) / self.k
        )
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(3)
        self.fitted = False

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def fit_gp(self, X, y, xtest=None, N=200):
        self.x = self._tensor(X)
        self.y = self._tensor(y).reshape(-1, 1)
        # precompute component Grams once
        self.Ks = torch.stack(
            [gram64(p.kernel_object, self.x) for p in self.processes], dim=0
        )
        self.fitted = True
        return True

    fit_GP = fit_gp

    def _draw_weights(self):
        return _dirichlet(self.generator, self._tensor(self.concentration))

    def _test_grams(self, xtest):
        cross = torch.stack([gram64(p.kernel_object, xtest, self.x)
                             for p in self.processes], dim=0)
        test = torch.stack([gram64(p.kernel_object, xtest)
                            for p in self.processes], dim=0)
        return cross, test

    def _mixed_posterior_sample(self, alpha, xtest, grams=None):
        """One posterior draw of the GP on Σ αₖKₖ at xtest. The moments are
        factored in float64 on the float64 Grams whatever the model's dtype;
        the draw is returned in the model's dtype."""
        f64 = torch.float64
        cross, test = grams if grams is not None else self._test_grams(xtest)
        a = alpha.to(f64)
        K = torch.einsum("k,kij->ij", a, self.Ks) + self.s**2 * \
            torch.eye(self.x.shape[0], dtype=f64, device=self.device)
        L = safe_cholesky(K).L
        A = cho_solve(L, self.y.to(f64))
        Ks_cross = torch.einsum("k,kij->ij", a, cross)
        mu = Ks_cross @ A
        Kss = torch.einsum("k,kij->ij", a, test)
        V = tri_solve(L, Ks_cross.T, lower=True)
        cov = Kss - V.T @ V
        Lc = safe_cholesky(cov, jitter=1e-8).L
        z = _normal(self.generator, (xtest.shape[0], 1), f64, mu.device)
        return (mu + Lc @ z).to(self.dtype)

    def sample(self, xtest, size=1):
        xtest = self._tensor(xtest)
        grams = self._test_grams(xtest)
        out = []
        for _ in range(size):
            alpha = self._draw_weights()
            out.append(self._mixed_posterior_sample(alpha, xtest, grams))
        return torch.cat(out, dim=1)

    def mean_var(self, xtest, N=100):
        samples = self.sample(xtest, size=N)
        return (
            torch.mean(samples, dim=1, keepdim=True),
            torch.std(samples, dim=1, keepdim=True, correction=0),
        )

    def mean_std(self, xtest, N=100):
        return self.mean_var(xtest, N=N)

    def ucb(self, xtest):
        mu, s = self.mean_var(xtest)
        return mu + 2 * s

    def lcb(self, xtest):
        mu, s = self.mean_var(xtest)
        return mu - 2 * s


class CategoricalMixture(DirichletMixture):
    """Mixture with categorical (vertex) weights: each draw picks one model
    with probability p_k."""

    def __init__(self, processes, probs=None, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__(processes, generator=generator, device=device,
                         dtype=dtype)
        self.probs = (
            self._tensor(probs)
            if probs is not None
            else torch.ones(self.k, dtype=dtype, device=self.device) / self.k
        )

    def _draw_weights(self):
        idx = _categorical(self.generator, torch.log(self.probs))
        w = torch.zeros(self.k, dtype=self.dtype, device=self.device)
        w[idx] = 1.0
        return w

    def map_model(self):
        """Highest-evidence component (model selection)."""
        evidences = []
        for p in self.processes:
            p.x, p.y = self.x, self.y
            evidences.append(float(p.log_marginal(p.kernel_object, {}, 1.0)))
        return int(np.argmin(evidences))
