"""Estimator base class: the common surface of the port's models.

Port of the base surface of stpy_tpu/models/estimator.py (`fit`, `ucb`,
`lcb`, `load_data`). Hyperparameter fitting (`optimize_params_general`,
`log_marginal`) needs the L-BFGS port and is ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from stpy_tpu_torch.config import as_tensor


class Estimator(ABC):
    x = None
    y = None
    s = 0.001
    device = torch.device("cpu")
    dtype = torch.float32

    def fit(self):
        raise NotImplementedError("subclasses implement fit()")

    @abstractmethod
    def ucb(self, x):
        ...

    @abstractmethod
    def lcb(self, x):
        ...

    def load_data(self, d):
        self.x = as_tensor(d[0], device=self.device, dtype=self.dtype)
        self.y = as_tensor(d[1], device=self.device,
                           dtype=self.dtype).reshape(-1, 1)
