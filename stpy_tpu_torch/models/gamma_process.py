"""Gamma-process regression: the exact GP with information-gain rate
functions γ(t) per kernel class (used by regret analyses).

Port of stpy_tpu/models/gamma_process.py on the port's `GaussianProcess`
(so every tier, the hand Gram kernels on the card included)."""

from __future__ import annotations

import numpy as np

from stpy_tpu_torch.models.exact_gp import GaussianProcess


class GammaContProcess(GaussianProcess):
    def get_gamma(self, t):
        """Maximal-information-gain growth rate for the kernel class."""
        name = self.kernel_object.optkernel
        if name == "squared_exponential" and self.kernel_object.groups is None:
            return (np.log(t)) ** self.d
        if name == "linear":
            return 10 * self.d
        if name == "squared_exponential":
            return len(self.kernel_object.groups) * np.log(t)
        if name in ("matern", "modified_matern"):
            return (np.log(t)) ** self.d
        return (np.log(t)) ** self.d

    def mean_var(self, xtest, full=False):
        return self.mean_std(xtest, full=full)
