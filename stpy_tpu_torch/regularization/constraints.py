"""Constraint objects exposing projections and penalties.

Port of stpy_tpu/regularization/constraints.py. Each constraint supplies
`penalty(theta)` (a smooth violation penalty), `project(theta)` (the
Euclidean projection where there is one) and `satisfied(theta)`. Matrices
given to a constructor become tensors of `dtype` on `device` (the card
unless the caller passes another); `theta` must live there too. The
spectral ones (`SDPConstraint`) take their eigendecomposition in float64
whatever A's dtype, as the port's other small eighs do
(`opt/ellipsoid._eigh64`), and return A's dtype.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.opt.prox import prox_l1


class Constraints(ABC):
    def __init__(self):
        self.convex = True

    def is_convex(self):
        return self.convex

    @abstractmethod
    def penalty(self, theta, rho=1e4):
        ...

    def satisfied(self, theta, tol=1e-7):
        return self.penalty(theta, rho=1.0) <= tol

    def project(self, theta):
        raise NotImplementedError


class CustomConstraint(Constraints):
    def __init__(self, fn: Callable, project_fn: Callable | None = None):
        super().__init__()
        self.fn = fn  # fn(theta) <= 0 means feasible
        self.project_fn = project_fn

    def penalty(self, theta, rho=1e4):
        return rho * torch.clamp(self.fn(theta), min=0.0) ** 2

    def project(self, theta):
        if self.project_fn is None:
            raise NotImplementedError
        return self.project_fn(theta)


class LinearConstraint(Constraints):
    """l ≤ A θ ≤ u."""

    def __init__(self, A, l=None, u=None, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.A = as_tensor(A, device=dev, dtype=dtype)
        inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
        self.l = -inf if l is None else as_tensor(l, device=dev, dtype=dtype)
        self.u = inf if u is None else as_tensor(u, device=dev, dtype=dtype)

    def penalty(self, theta, rho=1e4):
        z = self.A @ theta
        return rho * (
            torch.sum(torch.clamp(z - self.u, min=0.0) ** 2)
            + torch.sum(torch.clamp(self.l - z, min=0.0) ** 2)
        )

    def project(self, theta):
        # exact only when A == I (box); else use penalties
        n = self.A.shape[0]
        if n == self.A.shape[1] and bool(torch.all(
                self.A == torch.eye(n, dtype=self.A.dtype,
                                    device=self.A.device))):
            return torch.minimum(torch.maximum(theta, self.l), self.u)
        raise NotImplementedError


class AbsoluteValueConstraint(Constraints):
    """||θ||₁ ≤ c."""

    def __init__(self, c=1.0):
        super().__init__()
        self.c = c

    def penalty(self, theta, rho=1e4):
        return rho * torch.clamp(torch.sum(torch.abs(theta)) - self.c,
                                 min=0.0) ** 2

    def project(self, theta, iters=50):
        """Exact L1-ball projection by soft-threshold bisection."""
        a = torch.abs(theta)
        inside = torch.sum(a) <= self.c
        lo, hi = torch.zeros_like(a[0]), torch.max(a)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            over = torch.sum(torch.clamp(a - mid, min=0.0)) > self.c
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        return torch.where(inside, theta, prox_l1(theta, 0.5 * (lo + hi)))


class QuadraticInequalityConstraint(Constraints):
    """θᵀQθ - bᵀθ ≤ c."""

    def __init__(self, Q, b=None, c=1.0, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.Q = as_tensor(Q, device=dev, dtype=dtype)
        self.b = (
            torch.zeros(self.Q.shape[0], dtype=dtype, device=dev) if b is None
            else as_tensor(b, device=dev, dtype=dtype).reshape(-1)
        )
        self.c = c

    def penalty(self, theta, rho=1e4):
        v = theta @ (self.Q @ theta) - self.b @ theta - self.c
        return rho * torch.clamp(v, min=0.0) ** 2


class NonConvexNormConstraint(Constraints):
    """Lq-"ball" (q < 1) constraint Σ|θ/c|^q ≤ 1."""

    def __init__(self, q, c, d):
        super().__init__()
        self.q = q
        self.c = c
        self.d = d
        self.convex = False

    def penalty(self, theta, rho=1e4):
        v = torch.sum(torch.abs(theta / self.c) ** self.q) - 1.0
        return rho * torch.clamp(v, min=0.0) ** 2

    def project(self, theta):
        """Approximate: shrink radially until Σ|θ/c|^q ≤ 1."""
        val = torch.sum(torch.abs(theta / self.c) ** self.q)
        scale = torch.where(val > 1.0, (1.0 / val) ** (1.0 / self.q),
                            torch.ones_like(val))
        return theta * scale


class NonConvexGroupNormConstraint(NonConvexNormConstraint):
    def __init__(self, q, c, d, groups):
        super().__init__(q, c, d)
        self.groups = groups

    def penalty(self, theta, rho=1e4):
        v = (
            sum(
                torch.linalg.vector_norm(
                    theta[torch.as_tensor(g, device=theta.device)]) ** self.q
                for g in self.groups
            )
            / self.c**self.q
            - 1.0
        )
        return rho * torch.clamp(v, min=0.0) ** 2


def _sym64(A):
    A64 = A.to(torch.float64)
    return 0.5 * (A64 + A64.T)


class SDPConstraint(Constraints):
    """PSD matrix constraint set: A ⪰ 0 with trace/λmax bounds. Penalties
    use the spectrum; projection clips it."""

    def __init__(self, type="trace", rank=1.0, trace_constraint=None,
                 lambda_max_constraint=None):
        super().__init__()
        self.type = type
        self.rank = rank
        self.matrix_bound = rank if type == "stable-rank" else 1.0
        self.trace_constraint = trace_constraint
        self.lambda_max_constraint = lambda_max_constraint

    def get_type(self):
        return self.type

    def penalty(self, A, rho=1e4, l=1.0):
        w = torch.linalg.eigvalsh(_sym64(A))
        pen = torch.sum(torch.clamp(-w, min=0.0) ** 2)  # PSD violation
        if self.matrix_bound is not None:
            pen = pen + torch.clamp(torch.sum(w) - self.matrix_bound * l,
                                    min=0.0) ** 2
            pen = pen + torch.clamp(torch.max(w) - l, min=0.0) ** 2
        if self.trace_constraint is not None:
            pen = pen + torch.clamp(torch.sum(w) - self.trace_constraint,
                                    min=0.0) ** 2
        if self.lambda_max_constraint is not None:
            pen = pen + torch.clamp(
                torch.max(w) - self.lambda_max_constraint, min=0.0) ** 2
        return (rho * pen).to(A.dtype)

    def project(self, A):
        """Nearest PSD matrix (spectral clip), then trace rescale."""
        w, V = torch.linalg.eigh(_sym64(A))
        w = torch.clamp(w, min=0.0, max=self.lambda_max_constraint)
        A_psd = (V * w[None, :]) @ V.T
        if self.trace_constraint is not None:
            tr = torch.trace(A_psd)
            A_psd = A_psd * torch.where(
                tr > self.trace_constraint, self.trace_constraint / tr,
                torch.ones_like(tr))
        return A_psd.to(A.dtype)
