"""Permutation feature importance: the port of
stpy_tpu/feature_importance.py.

`FeatureRanker` scores a fitted model's mean on (x, y) and reports how
much the score degrades when a column is permuted (`importance`, the
permutations from a `torch.Generator`, default seeded 0 as the JAX
package's key) or set to its mean (`one_off_importance`). The data live
on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor


def _permutation(generator, n):
    """A random permutation of range(n) from `generator` on its device."""
    return torch.randperm(n, generator=generator, device=generator.device)


class FeatureRanker:
    def __init__(self, model, x, y, metric=None, generator=None):
        self.model = model
        dev, dt = model.device, model.dtype
        self.x = as_tensor(x, device=dev, dtype=dt)
        self.y = as_tensor(y, device=dev, dtype=dt).reshape(-1, 1)
        self.metric = metric or (
            lambda yp, yt: float(torch.mean((yp - yt) ** 2))
        )
        self.generator = (generator if generator is not None
                          else torch.Generator(device=dev).manual_seed(0))

    def _score(self, x):
        mu = self.model.mean_std(x)[0]
        return self.metric(mu, self.y)

    def importance(self, repeats=5):
        """Permutation importance: the mean score degradation over
        `repeats` permutations of column j, for each j."""
        base = self._score(self.x)
        n, d = self.x.shape
        out = np.zeros(d)
        for j in range(d):
            vals = []
            for _ in range(repeats):
                perm = _permutation(self.generator, n).to(self.x.device)
                xp = self.x.clone()
                xp[:, j] = self.x[perm, j]
                vals.append(self._score(xp))
            out[j] = np.mean(vals) - base
        return out

    def one_off_importance(self):
        """Score degradation when column j is set to its mean."""
        base = self._score(self.x)
        d = self.x.shape[1]
        out = np.zeros(d)
        for j in range(d):
            xz = self.x.clone()
            xz[:, j] = torch.mean(self.x[:, j])
            out[j] = self._score(xz) - base
        return out
