"""Conditional VAE, a generative model for candidate sets: the port of
stpy_tpu/generative_models/cvae.py.

The encoder and decoder are `nn.Module`s of the JAX package's flax layout
(one hidden ReLU layer each; the decoder ends in a sigmoid), initialised as
flax's `Dense` is (truncated LeCun-normal weights, zero biases) from a
`torch.Generator` seeded with `seed`, and trained on the ELBO by
`torch.optim.Adam`. The model lives on the card (or `device`) in `dtype`.
Where a JAX method takes parameters and a key, the port's holds its
parameters and takes a generator; `convert.cvae_params_from_jax` carries
the JAX package's parameters across.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from stpy_tpu_torch.config import as_tensor, resolve_device


# the standard deviation of N(0, 1) truncated at ±2 (flax's lecun_normal
# divides by it)
_TRUNC_STD = 0.87962566103423978


def _normal(generator, shape, like):
    """Standard normals of `like`'s dtype from `generator`, on `like`'s
    device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def _permutation(generator, n):
    """A random permutation of range(n) from `generator` on its device."""
    return torch.randperm(n, generator=generator, device=generator.device)


def one_hot(labels, class_size, device=None, dtype=torch.float32):
    labels = as_tensor(labels, device=resolve_device(device),
                       dtype=torch.long)
    return nn.functional.one_hot(labels, class_size).to(dtype)


class _Encoder(nn.Module):
    def __init__(self, inputs, latent, mid):
        super().__init__()
        self.hidden = nn.Linear(inputs, mid)
        self.mu = nn.Linear(mid, latent)
        self.logvar = nn.Linear(mid, latent)

    def forward(self, x, y):
        h = torch.relu(self.hidden(torch.cat([x, y], dim=-1)))
        return self.mu(h), self.logvar(h)


class _Decoder(nn.Module):
    def __init__(self, inputs, out, mid):
        super().__init__()
        self.hidden = nn.Linear(inputs, mid)
        self.out = nn.Linear(mid, out)

    def forward(self, z, y):
        h = torch.relu(self.hidden(torch.cat([z, y], dim=-1)))
        return torch.sigmoid(self.out(h))


class CVAE(nn.Module):
    def __init__(self, feature_size, latent_size, output_size=None,
                 cond_size=10, midsize=400, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.feature_size = feature_size
        self.latent_size = latent_size
        self.output_size = output_size or feature_size
        self.cond_size = cond_size
        self.device, self.dtype = resolve_device(device), dtype
        self.enc = _Encoder(feature_size + cond_size, latent_size, midsize)
        self.dec = _Decoder(latent_size + cond_size, self.output_size,
                            midsize)
        self.to(device=self.device, dtype=dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            for layer in self.modules():
                if isinstance(layer, nn.Linear):
                    # flax's lecun_normal: N(0, 1/fan_in) truncated at two
                    # standard deviations, rescaled to keep its variance
                    std = layer.in_features ** -0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                          b=2 * std, generator=self.generator)
                    nn.init.zeros_(layer.bias)

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def encode(self, x, y):
        return self.enc(x, y)

    def reparameterize(self, mu, logvar, generator=None):
        std = torch.exp(0.5 * logvar)
        return mu + std * _normal(generator or self.generator, mu.shape, mu)

    def decode(self, z, y):
        return self.dec(z, y)

    def elbo_loss(self, x, y, generator=None):
        """The negative ELBO summed over the rows: binary cross-entropy of
        the reconstruction plus the KL divergence from the prior, z drawn
        from `generator` (the model's own where None)."""
        mu, logvar = self.encode(x, y)
        z = self.reparameterize(mu, logvar, generator)
        recon = self.decode(z, y)
        bce = -torch.sum(
            x * torch.log(torch.clamp(recon, min=1e-8))
            + (1 - x) * torch.log(torch.clamp(1 - recon, min=1e-8))
        )
        kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))
        return bce + kld

    def fit(self, X, Y, epochs=50, batch=128, lr=1e-3, verbose=False):
        """Adam on the negative ELBO: each epoch a fresh permutation of the
        rows in batches of `batch`, the permutations and the draws of z
        from the model's generator."""
        X = self._tensor(X).reshape(-1, self.feature_size)
        Y = self._tensor(Y).reshape(-1, self.cond_size)
        opt = torch.optim.Adam(self.parameters(), lr=lr)
        n = X.shape[0]
        for ep in range(epochs):
            perm = _permutation(self.generator, n).to(self.device)
            tot = 0.0
            for i in range(0, n, batch):
                idx = perm[i : i + batch]
                loss = self.elbo_loss(X[idx], Y[idx])
                opt.zero_grad()
                loss.backward()
                opt.step()
                tot += float(loss.detach())
            if verbose:
                print(f"epoch {ep}: loss {tot / n:.4f}")
        return self

    @torch.no_grad()
    def sample(self, y, size=1, generator=None):
        """Decoded prior draws z for the conditions y (one row repeated
        `size` times), z from `generator` (a fresh one seeded from numpy's
        global state where None)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                int(np.random.randint(2**31)))
        y = self._tensor(y).reshape(-1, self.cond_size)
        y = y.repeat(size, 1) if y.shape[0] == 1 else y
        z = _normal(generator, (y.shape[0], self.latent_size), y)
        return self.decode(z, y)
