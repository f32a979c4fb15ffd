"""GaussianProcessFF: a Fourier-feature GP with an `approx` selector and
additive per-group blocks, a configuration layer over KernelizedFeatures
and AdditiveEmbeddings. Port of stpy_tpu/models/fourier_gp.py; the
embeddings take ``device`` (None: the card) and ``dtype``."""

from __future__ import annotations

import torch

from stpy_tpu_torch.embeddings import (
    AdditiveEmbeddings,
    ClenshawCurtisEmbedding,
    HermiteEmbedding,
    KLEmbedding,
    MaternEmbedding,
    QuadPeriodicEmbedding,
    QuadratureEmbedding,
    RFFEmbedding,
    TrapezoidalEmbedding,
)
from stpy_tpu_torch.models.feature_gp import KernelizedFeatures


def sample_embedding(approx, m, d, gamma, nu=2, kernel="squared_exponential",
                     **kwargs):
    """The embedding `approx` names: rff / rff2 / halton / orf (RFF), quad,
    hermite, trapezoidal, ccff, matern_specific, quad_periodic, kl."""
    if approx in ("rff", "rff2"):
        return RFFEmbedding(gamma=gamma, m=m, d=d, kernel=kernel,
                            approx="rff", **kwargs)
    if approx == "halton":
        return RFFEmbedding(gamma=gamma, m=m, d=d, kernel=kernel,
                            approx="halton", **kwargs)
    if approx == "orf":
        return RFFEmbedding(gamma=gamma, m=m, d=d, kernel=kernel,
                            approx="orf", **kwargs)
    if approx == "quad":
        return QuadratureEmbedding(gamma=gamma, m=m, d=d, kernel=kernel,
                                   **kwargs)
    if approx == "hermite":
        return HermiteEmbedding(gamma=gamma, m=m, d=d, **kwargs)
    if approx == "trapezoidal":
        return TrapezoidalEmbedding(gamma=gamma, m=m, d=d, **kwargs)
    if approx == "ccff":
        return ClenshawCurtisEmbedding(gamma=gamma, m=m, d=d, **kwargs)
    if approx == "matern_specific":
        return MaternEmbedding(gamma=gamma, m=m, d=d,
                               kernel="modified_matern", nu=nu, **kwargs)
    if approx == "quad_periodic":
        return QuadPeriodicEmbedding(gamma=gamma, m=m, d=d, **kwargs)
    if approx == "kl":
        return KLEmbedding(gamma=gamma, m=m, d=d, **kwargs)
    raise AssertionError(f"approx={approx} not implemented")


class GaussianProcessFF(KernelizedFeatures):
    def __init__(self, gamma=0.5, s=0.001, m=256, d=1, approx="hermite",
                 kernel="squared_exponential", nu=2, groups=None, lam=1.0,
                 bounds=None, diameter=1.0, device=None, dtype=torch.float32,
                 **kwargs):
        place = dict(device=device, dtype=dtype)
        if groups is None:
            embedding = sample_embedding(approx, m, d, gamma, nu=nu,
                                         kernel=kernel, **place)
        else:
            per = [
                sample_embedding(
                    approx, m // len(groups) if m >= 2 * len(groups) else m,
                    len(g), gamma, nu=nu, kernel=kernel, **place,
                )
                for g in groups
            ]
            embedding = AdditiveEmbeddings(per, groups=groups)
        super().__init__(
            embedding=embedding, m=embedding.get_m(), s=s, lam=lam, d=d,
            bounds=bounds, diameter=diameter, groups=groups,
        )
        self.approx = approx
        self.gamma = gamma
