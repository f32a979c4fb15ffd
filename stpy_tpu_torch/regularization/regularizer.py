"""Regularizer objects: value, prox and hessian as tensor functions.

Port of stpy_tpu/regularization/regularizer.py on the port's
`opt/prox.prox_l1` / `prox_group_l2`. Each method follows its argument's
device and dtype; the reference's "cvxpy objective" is `eval`.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch

from stpy_tpu_torch.opt.prox import prox_group_l2, prox_l1


def _index(g, theta):
    return torch.as_tensor(g, device=theta.device)


class Regularizer(ABC):
    def __init__(self, lam=1.0):
        self.lam = lam
        self.groups = None
        self.convex = True

    @abstractmethod
    def eval(self, theta):
        ...

    def value(self, theta):
        return self.eval(theta)

    def prox(self, theta, step):
        """Proximal operator of step·reg at theta; default = identity
        (smooth regularizers are handled by gradient flow)."""
        return theta

    def hessian(self, theta):
        return None

    def is_convex(self):
        return self.convex

    # reference-name shim: the emitted "cvxpy objective" is just `eval`
    def get_regularizer_cvxpy(self):
        return self.eval

    def get_constraint_level_set(self, c):
        """Indicator of {θ : reg(θ) ≤ c} as a penalty closure."""
        return lambda theta, rho=1e4: rho * torch.clamp(
            self.eval(theta) - c, min=0.0) ** 2


class L2Regularizer(Regularizer):
    def eval(self, theta):
        return self.lam * torch.sum(theta**2) / 2.0

    def prox(self, theta, step):
        return theta / (1.0 + step * self.lam)

    def hessian(self, theta):
        return self.lam * torch.eye(theta.shape[0], dtype=theta.dtype,
                                    device=theta.device) / 2.0


class L1Regularizer(Regularizer):
    def eval(self, theta):
        return self.lam * torch.sum(torch.abs(theta))

    def prox(self, theta, step):
        return prox_l1(theta, step * self.lam)

    def hessian(self, theta):
        return self.lam * torch.eye(theta.shape[0], dtype=theta.dtype,
                                    device=theta.device)


class GroupL1L2Regularizer(Regularizer):
    """Σ_g w_g ||θ_g||₂ (group lasso)."""

    def __init__(self, lam=1.0, groups=None, weights=None):
        super().__init__(lam=lam)
        self.groups = groups
        self.weights = (
            weights if weights is not None else [1.0] * len(groups)
        )

    def eval(self, theta):
        return self.lam * sum(
            w * torch.linalg.vector_norm(theta[_index(g, theta)])
            for g, w in zip(self.groups, self.weights)
        )

    def prox(self, theta, step):
        return prox_group_l2(theta, step * self.lam, self.groups)


class NestedGroupL1L2Regularizer(GroupL1L2Regularizer):
    """Hierarchical/nested group lasso (groups may overlap); prox by
    sequential group shrinkage (exact for tree-nested groups)."""

    def prox(self, theta, step):
        out = theta
        for g, w in zip(self.groups, self.weights):
            out = prox_group_l2(out, step * self.lam * w, [g])
        return out


class NonConvexLqRegularizer(Regularizer):
    """λ Σ |θ_i|^q with q < 1; majorized by reweighted L2."""

    def __init__(self, lam=1.0, q=0.5):
        super().__init__(lam=lam)
        self.q = q
        self.convex = False

    def eval(self, theta):
        return self.lam * torch.sum(torch.abs(theta) ** self.q)

    def majorizer_weights(self, eta, eps=1e-10):
        """Reweighted-L2 surrogate: reg(θ) ≤ q/2 Σ θ_i²/η_i^{2-q} + const."""
        return 0.5 * self.q * self.lam / (torch.abs(eta) ** (2 - self.q) + eps)

    def surrogate(self, eta):
        w = self.majorizer_weights(eta)
        return lambda theta: torch.sum(w * theta**2)


class GroupNonConvexLqRegularizer(NonConvexLqRegularizer):
    def __init__(self, lam=1.0, q=0.5, groups=None):
        super().__init__(lam=lam, q=q)
        self.groups = groups

    def eval(self, theta):
        return self.lam * sum(
            torch.linalg.vector_norm(theta[_index(g, theta)]) ** self.q
            for g in self.groups
        )

    def surrogate(self, eta_groups):
        """eta_groups: one scale per group."""
        def reg(theta):
            val = 0.0
            for i, g in enumerate(self.groups):
                w = 0.5 * self.q * self.lam / (
                    torch.abs(torch.as_tensor(eta_groups[i])) ** (2 - self.q)
                    + 1e-10
                )
                val = val + w * torch.sum(theta[_index(g, theta)] ** 2)
            return val

        return reg
