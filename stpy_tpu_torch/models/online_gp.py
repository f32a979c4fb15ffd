"""OnlineGP: a sequential GP for BO and active-learning loops whose state
never grows or moves.

Port of stpy_tpu/models/online_gp.py. The JAX module pads its buffers to a
capacity so that `add_data_point` and `mean_std` each stay one compiled
program for the whole loop. The port's counterpart of that stability is
memory: every buffer (the points, the targets, the (cap, cap) factor and
alpha) is allocated once, on the model's device, at `capacity`, and each
step writes into it in place, so a step neither reallocates nor grows the
state (their `data_ptr()` stay fixed across adds):

  * the Cholesky factor is kept as block-diag(L_active, I): the rows and
    columns past `count` are the identity's;
  * adding a point appends one row of L by a masked triangular solve, in
    O(cap²) work and without refactorizing, then refreshes alpha by two
    triangular solves;
  * predictions mask the inactive tail.

The incremental factor follows the batch Cholesky's recurrence, so the
posterior is `GaussianProcess`'s to rounding. Its cross Grams go through
the Gram kernel (csrc/gram.cu on the card). The plots come from the
`viz.RandomProcess` mixin.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.viz import RandomProcess


class OnlineGP(RandomProcess):
    def __init__(self, kernel_object, s=0.1, capacity=1024, d=1):
        self.kernel_object = kernel_object
        self.device = kernel_object.device
        self.dtype = kernel_object.dtype
        self.s = s
        self.capacity = int(capacity)
        self.d = int(d)
        cap, kw = self.capacity, dict(dtype=self.dtype, device=self.device)
        self.x_buf = torch.zeros((cap, self.d), **kw)
        self.y_buf = torch.zeros((cap, 1), **kw)
        self.L = torch.eye(cap, **kw)
        self.alpha = torch.zeros((cap, 1), **kw)
        self.count = 0
        # the work vectors of a step, allocated once as well
        self._index = torch.arange(cap, device=self.device)
        self._w = torch.zeros((cap, 1), **kw)
        self._z = torch.zeros((cap, 1), **kw)

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _mask(self, count):
        return (self._index < count).to(self.dtype)

    def add_data_point(self, x, y):
        x = self._tensor(x).reshape(1, self.d)
        y = self._tensor(y).reshape(1, 1)
        assert self.count < self.capacity, "capacity exhausted"
        idx, ko = self.count, self.kernel_object
        pd = ko.params_dict
        self.x_buf[idx] = x[0]
        self.y_buf[idx] = y[0]
        mask = self._mask(idx)
        # the cross Gram against the active points (masked); the padded
        # block of L is the identity and k is zero there
        k_col = ko.eval_params(pd, self.x_buf, x) * mask[:, None]
        kss = ko.diag(x, pd)[0] + self.s * self.s
        torch.linalg.solve_triangular(self.L, k_col, upper=False, out=self._w)
        self._w.mul_(mask[:, None])
        w = self._w[:, 0]
        w[idx] = torch.sqrt(torch.clamp(kss - w @ w, min=1e-12))
        self.L[idx] = w                  # the new row: [w, diag, 0, …]
        self.count = idx + 1
        # alpha by two triangular solves on the masked targets (O(cap²))
        torch.mul(self.y_buf, self._mask(self.count)[:, None], out=self._z)
        torch.linalg.solve_triangular(self.L, self._z, upper=False,
                                      out=self._w)
        torch.linalg.solve_triangular(self.L.T, self._w, upper=True,
                                      out=self.alpha)

    def fit_gp(self, x, y):
        """Bulk load by repeated O(cap²) appends (use GaussianProcess for
        large batch fits)."""
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        for i in range(x.shape[0]):
            self.add_data_point(x[i:i + 1], y[i:i + 1])

    def mean_std(self, xtest):
        ko = self.kernel_object
        pd = ko.params_dict
        xtest = self._tensor(xtest).reshape(-1, self.d)
        mask = self._mask(self.count)
        K_star = ko.eval_params(pd, xtest, self.x_buf) * mask
        mu = K_star @ self.alpha
        V = torch.linalg.solve_triangular(self.L, K_star.T, upper=False)
        V = V * mask[:, None]
        var = torch.clamp(ko.diag(xtest, pd) - torch.sum(V * V, dim=0),
                          min=1e-30)
        return mu, torch.sqrt(var)[:, None]

    def mean(self, xtest):
        return self.mean_std(xtest)[0]

    def ucb(self, xtest, beta=2.0):
        mu, std = self.mean_std(xtest)
        return mu + beta * std

    def lcb(self, xtest, beta=2.0):
        mu, std = self.mean_std(xtest)
        return mu - beta * std

    @property
    def x(self):
        return self.x_buf[:self.count]

    @property
    def y(self):
        return self.y_buf[:self.count]
