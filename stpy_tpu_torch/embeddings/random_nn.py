"""Random neural-network feature maps.

Port of stpy_tpu/embeddings/random_nn.py. The random weights come from a
`torch.Generator` seeded with `seed` (the JAX package splits a PRNGKey; its
draws cannot be reproduced here, so `convert.load_embedding_state` carries
them across), drawn on the host and moved to the map's device. The readout
fit is Adam (`torch.optim.Adam` at optax.adam's defaults: β = (0.9, 0.999),
eps = 1e-8 added outside the square root) over the same ridge(+L1) loss.
"""

from __future__ import annotations

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


class RandomMap:
    """One random hidden layer and a trainable readout: Φ(x) = f(x W₁ᵀ) W₂."""

    def __init__(self, d, m, fun=torch.tanh, output=2, seed=0, device=None,
                 dtype=torch.float32):
        self.d, self.m, self.output = d, m, output
        self.fun = fun
        self.device, self.dtype = resolve_device(device), dtype
        g = torch.Generator().manual_seed(seed)
        self.W1 = self._draw((m, d), g) / np.sqrt(d)
        self.W2 = self._draw((m, output), g) / np.sqrt(m)

    def _draw(self, shape, generator):
        return torch.randn(shape, generator=generator, dtype=self.dtype).to(
            self.device)

    def _tensor(self, x):
        return as_tensor(x, device=self.device, dtype=self.dtype)

    def hidden(self, x):
        return self.fun(self._tensor(x) @ self.W1.T)

    def map(self, x):
        return self.hidden(x) @ self.W2

    forward = map

    def embed(self, x):
        return self.hidden(x)

    def get_m(self):
        return self.m

    def get_params(self):
        return (self.W1, self.W2)

    def get_params_last(self):
        return self.W2

    def fit_map(self, x, y, epochs=1000, verbose=False, reg=0.1, lr=0.1,
                l1=0.0):
        """Fit the readout W₂ by `epochs` Adam steps on
        mean((H W₂ − y)²) + reg‖W₂‖² (+ l1‖W₂‖₁)."""
        y = self._tensor(y).reshape(-1, self.output)
        H = self.hidden(x).detach()
        W2 = self.W2.detach().clone().requires_grad_()
        opt = torch.optim.Adam([W2], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        with torch.enable_grad():
            for _ in range(epochs):
                opt.zero_grad()
                val = torch.mean((H @ W2 - y) ** 2) + reg * torch.sum(W2**2)
                if l1 > 0:
                    val = val + l1 * torch.sum(torch.abs(W2))
                val.backward()
                opt.step()
        self.W2 = W2.detach()
        return self.W2

    def fit_map_lasso(self, x, y, epochs=1000, verbose=False, reg=0.1,
                      lr=0.1, l1=0.1):
        return self.fit_map(x, y, epochs=epochs, reg=reg, lr=lr, l1=l1)

    def fit_last_layer(self, x=None, y=None):
        """Closed-form ridge readout."""
        H = self.hidden(x)
        y = self._tensor(y).reshape(-1, self.output)
        A = H.T @ H + 0.1 * torch.eye(self.m, dtype=H.dtype, device=H.device)
        self.W2 = torch.linalg.solve(A, H.T @ y)
        return self.W2

    def loss(self, x, y):
        pred = self.map(x)
        return torch.mean((pred - self._tensor(y).reshape(-1, self.output)) ** 2)


class RandomOrthogonalMap(RandomMap):
    """Hidden weights from an orthogonal matrix (numpy QR, seeded)."""

    def __init__(self, d, m, fun=torch.tanh, output=2, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__(d, m, fun=fun, output=output, seed=seed,
                         device=device, dtype=dtype)
        rng = np.random.default_rng(seed)
        G = rng.standard_normal((max(m, d), max(m, d)))
        Q, _ = np.linalg.qr(G)
        self.W1 = self._tensor(Q[:m, :d])


class RandomNestedMap(RandomMap):
    """Two stacked random layers."""

    def __init__(self, d, m, fun=torch.tanh, output=1, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__(d, m, fun=fun, output=output, seed=seed,
                         device=device, dtype=dtype)
        g = torch.Generator().manual_seed(seed + 1)
        self.W_mid = self._draw((m, m), g) / np.sqrt(m)

    def hidden(self, x):
        h1 = self.fun(self._tensor(x) @ self.W1.T)
        return self.fun(h1 @ self.W_mid.T)
