"""Embedding combinators: concat, masked, additive per group, projective,
weighted. Port of stpy_tpu/embeddings/combinators.py; a combinator lives on
the device and dtype of its (first) inner embedding."""

from __future__ import annotations

from typing import Callable, List

import torch

from stpy_tpu_torch.embeddings.base import Embedding


class ConcatEmbedding(Embedding):
    """Embeddings side by side."""

    def __init__(self, embeddings: List[Embedding]):
        self.embeddings = embeddings
        self.m = sum(int(e.get_m()) for e in embeddings)
        self.d = embeddings[0].d
        self._place(embeddings[0].device, embeddings[0].dtype)

    def embed(self, x):
        return torch.cat([e.embed(x) for e in self.embeddings], dim=1)

    def get_m(self):
        return self.m

    def integral(self, S):
        return torch.cat([e.integral(S) for e in self.embeddings])


class MaskedEmbedding(Embedding):
    """Another embedding with each row scaled by mask(x)."""

    def __init__(self, embedding: Embedding, mask: Callable):
        self.embedding = embedding
        self.m = embedding.get_m()
        self.d = embedding.d
        self.mask = mask
        self._place(embedding.device, embedding.dtype)

    def embed(self, x):
        x = self._tensor(x)
        return self.mask(x).reshape(-1, 1) * self.embedding.embed(x)

    def get_m(self):
        return self.m


class AdditiveEmbeddings(Embedding):
    """Per-group blocks Φ(x) = [s_1 Φ_1(x_{G_1}), …], the feature form of an
    additive kernel."""

    def __init__(self, embeddings, ms=None, groups=None, scaling=None,
                 additive=True):
        self.embeddings = list(embeddings)
        self.no_emb = len(self.embeddings)
        self._place(self.embeddings[0].device, self.embeddings[0].dtype)
        self.groups = (
            groups if groups is not None else [[i] for i in range(self.no_emb)]
        )
        self.ms = (
            [int(m) for m in ms]
            if ms is not None
            else [int(e.get_m()) for e in self.embeddings]
        )
        self.scaling = (
            self._tensor(scaling)
            if scaling is not None
            else torch.ones(self.no_emb, dtype=self.dtype, device=self.device)
        )
        self.additive = additive
        self.m = int(sum(self.ms))

    def embed(self, x):
        x = self._tensor(x)
        blocks = []
        for i, emb in enumerate(self.embeddings):
            idx = torch.as_tensor(self.groups[i], device=x.device)
            blocks.append(
                emb.embed(x[:, idx].reshape(-1, len(self.groups[i])))
                * self.scaling[i]
            )
        return torch.cat(blocks, dim=1)

    def get_m(self):
        return self.m


class ProjectiveEmbeddings(Embedding):
    """Embed after a projection map."""

    def __init__(self, embedding: Embedding, project: Callable):
        self.embedding = embedding
        self.project = project
        self.m = embedding.get_m()
        self._place(embedding.device, embedding.dtype)

    def embed(self, x):
        return self.embedding.embed(self.project(self._tensor(x)))

    def get_m(self):
        return self.m


class WeightedEmbedding(Embedding):
    """Per-feature weights w ⊙ Φ(x)."""

    def __init__(self, embedding: Embedding, weights=None):
        self.embedding = embedding
        self.m = embedding.get_m()
        self.d = embedding.d
        self._place(embedding.device, embedding.dtype)
        self.weights = (
            self._tensor(weights)
            if weights is not None
            else torch.ones(self.m, dtype=self.dtype, device=self.device)
        )

    def embed(self, x):
        return self.embedding.embed(x) * self.weights[None, :]

    def get_m(self):
        return self.m

    def integral(self, S):
        return self.embedding.integral(S) * self.weights
