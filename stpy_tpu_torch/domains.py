"""Borel sets (domains) with quadrature discretizations.

Port of stpy_tpu/domains.py: `BorelSet`, `BallSet`, `Node`,
`HierarchicalBorelSets` and the point sets `CandidateSet`,
`CandidateDiscreteSet`. The geometry is host-side (numpy, float64 of the
bounds rounded to the set's dtype, as the JAX package rounds them to its
default dtype); every array handed back is a tensor of the set's dtype on
its device (None: the card, config.resolve_device). Random draws come from
an explicit `torch.Generator`.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.utils.helper import cartesian


class BorelSet:
    """Axis-aligned box  prod_i [a_i, b_i)  in R^d."""

    type = "box"

    def __init__(self, d: int, bounds, device=None, dtype=torch.float32):
        self.d = d
        self.device, self.dtype = resolve_device(device), dtype
        self.bounds = self._tensor(np.asarray(bounds, dtype=float).reshape(d, 2))
        self._bounds_np = self.bounds.cpu().double().numpy()
        self.vol = float(np.prod(self._bounds_np[:, 1] - self._bounds_np[:, 0]))

    def _tensor(self, x):
        return as_tensor(x, device=self.device, dtype=self.dtype)

    # -- geometry ----------------------------------------------------------
    def description(self):
        return self.bounds

    def volume(self) -> float:
        return self.vol

    def center_point(self) -> torch.Tensor:
        return (self.bounds[:, 1] + self.bounds[:, 0]) / 2.0

    def perimeter(self) -> float:
        return float(2.0 * np.sum(self._bounds_np[:, 1] - self._bounds_np[:, 0]))

    def inside(self, other: "BorelSet") -> bool:
        """True if `other` (a box) is contained in this box."""
        ob = other._bounds_np
        return bool(
            np.all(self._bounds_np[:, 0] <= ob[:, 0])
            and np.all(self._bounds_np[:, 1] >= ob[:, 1])
        )

    def is_inside(self, x: torch.Tensor) -> torch.Tensor:
        """Membership mask for x of shape (n, d), on x's device."""
        b = self.bounds.to(device=x.device, dtype=x.dtype)
        return torch.all((x >= b[:, 0]) & (x < b[:, 1]), dim=-1)

    # -- sampling / discretization ------------------------------------------
    def uniform_sample(self, generator, n: int) -> torch.Tensor:
        """n uniform points drawn from `generator`."""
        u = torch.rand((n, self.d), generator=generator, dtype=self.dtype,
                       device=generator.device).to(self.device)
        return self.bounds[:, 0] + u * (self.bounds[:, 1] - self.bounds[:, 0])

    def return_discretization(self, n: int, offsets=None) -> torch.Tensor:
        """Tensor grid with n points per dimension, shape (n**d, d)."""
        xs = []
        for i in range(self.d):
            a, b = self._bounds_np[i]
            if offsets is not None:
                a, b = a - offsets[i], b + offsets[i]
            xs.append(np.linspace(a, b, n))
        return self._tensor(cartesian(xs))

    def return_legendre_discretization(self, n: int):
        """Tensor-product Gauss-Legendre rule: (weights (n**d,), nodes
        (n**d, d)), with sum_i w_i f(x_i) ≈ ∫_S f (nodes scaled per
        dimension, as stpy_tpu/domains.py:80-99)."""
        nodes0, weights0 = np.polynomial.legendre.leggauss(n)
        nodes_arr, weights_arr = [], []
        for i in range(self.d):
            a, b = self._bounds_np[i]
            nodes_arr.append(nodes0 * (b - a) / 2.0 + (a + b) / 2.0)
            weights_arr.append(weights0 * 0.5 * (b - a))
        nodes = cartesian(nodes_arr)
        weights = np.prod(cartesian(weights_arr), axis=1)
        return self._tensor(weights), self._tensor(nodes)


class BallSet(BorelSet):
    """Euclidean ball; quadrature supported for d in {1, 2}."""

    type = "round"

    def __init__(self, d: int, center, radius: float, device=None,
                 dtype=torch.float32):
        self.d = d
        self.device, self.dtype = resolve_device(device), dtype
        self.center = self._tensor(np.asarray(center, dtype=float)).reshape(d)
        self.radius = float(radius)
        self.vol = (self.radius**d) * math.pi ** (d / 2.0) / math.gamma(d / 2.0 + 1)
        c = self.center.cpu().double().numpy()
        # bounding box, used for grid discretizations
        self.bounds = self._tensor(np.stack([c - self.radius, c + self.radius],
                                            axis=1))
        self._bounds_np = self.bounds.cpu().double().numpy()

    def description(self):
        return self.center, self.radius

    def _center_np(self):
        return self.center.cpu().double().numpy()

    def inside(self, other) -> bool:
        c = self._center_np()
        if other.type == "box":
            ob = other._bounds_np
            # farthest corner of the box from the center must be within radius
            corner = np.maximum(np.abs(ob[:, 0] - c), np.abs(ob[:, 1] - c))
            return bool(np.sum(corner**2) <= self.radius**2)
        dist = np.linalg.norm(c - other._center_np())
        return bool(dist + other.radius <= self.radius)

    def is_inside(self, x: torch.Tensor) -> torch.Tensor:
        c = self.center.to(device=x.device, dtype=x.dtype)
        return torch.sum((x - c) ** 2, dim=-1) <= self.radius**2

    def uniform_sample(self, generator, n: int) -> torch.Tensor:
        """Rejection-free: direction ~ normal, radius ~ U^(1/d)·R; the
        normals first, then the uniforms, from `generator`."""
        kw = dict(generator=generator, dtype=self.dtype, device=generator.device)
        z = torch.randn((n, self.d), **kw).to(self.device)
        z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
        r = self.radius * torch.rand((n, 1), **kw).to(self.device) ** (
            1.0 / self.d)
        return self.center + z * r

    def return_legendre_discretization(self, n: int):
        """Quadrature over the ball. d = 1: Gauss-Legendre on the interval;
        d = 2: Gauss-Chebyshev (angular) × Gauss-Legendre (chord)."""
        if self.d == 1:
            return super().return_legendre_discretization(n)
        if self.d != 2:
            raise NotImplementedError("BallSet quadrature only for d<=2")
        p, w = np.polynomial.legendre.leggauss(n)
        mu = np.arange(1, n + 1)
        sin_mu = np.sin(mu * np.pi / (n + 1))
        cos_mu = np.cos(mu * np.pi / (n + 1))
        xs = np.tile(self.radius * cos_mu, n)
        ys = np.outer(p, self.radius * sin_mu).flatten()
        points = np.stack([xs, ys], axis=1) + self._center_np()
        weights = np.outer(w, sin_mu**2).flatten() * (
            np.pi * self.radius**2 / (n + 1)
        )
        return self._tensor(weights), self._tensor(points)

    def return_discretization(self, n: int, offsets=None) -> torch.Tensor:
        if self.d == 1:
            return super().return_discretization(n)
        _, pts = self.return_legendre_discretization(n)
        return pts


class Node(BorelSet):
    """BorelSet that participates in a hierarchy (binary in 1d, quad in 2d)."""

    def __init__(self, d, bounds, parent, device=None, dtype=torch.float32):
        super().__init__(d, bounds, device=device, dtype=dtype)
        self.left = None
        self.right = None
        self.children = None
        self.parent = parent
        self.level = 1 if parent is None else parent.level + 1


class HierarchicalBorelSets:
    """Dyadic hierarchy of boxes: each set splits into 2^d children, in the
    order of the binary masks (stpy_tpu/domains.py:194-248)."""

    def __init__(self, d: int, interval, levels: int, device=None,
                 dtype=torch.float32):
        self.device, self.dtype = resolve_device(device), dtype
        bounds = np.asarray(interval, dtype=float).reshape(d, 2)
        self.top_node = self._node(d, bounds, None)
        self.Sets = [self.top_node]
        self.levels = levels
        self.d = d
        self._construct(bounds, levels, self.top_node)

    def _node(self, d, bounds, parent):
        return Node(d, bounds, parent, device=self.device, dtype=self.dtype)

    def get_parent_set(self) -> Node:
        return self.top_node

    def get_sets_level(self, l: int) -> list:
        return [s for s in self.Sets if s.level == l]

    def get_all_sets(self) -> list:
        return self.Sets

    def get_leafs(self) -> list:
        return self.get_sets_level(self.levels)

    def get_ball_coverings(self, n: int, radius="auto") -> list:
        D = self.get_parent_set()
        centers = D.return_discretization(n).cpu().double().numpy()
        m = centers.shape[0]
        r = 2.0 / m if radius == "auto" else radius
        return [BallSet(D.d, centers[i], r, device=self.device,
                        dtype=self.dtype) for i in range(m)]

    def _construct(self, bounds, levels, parent):
        """2^d-ary dyadic split to `levels`; child order = binary masks in
        lexicographic order (left/right in 1d, the quadrants in 2d)."""
        if levels <= 1:
            return
        mids = bounds.mean(axis=1)
        children = []
        for mask in itertools.product((0, 1), repeat=self.d):
            mask = np.asarray(mask)
            nb = np.stack([np.where(mask == 0, bounds[:, 0], mids),
                           np.where(mask == 0, mids, bounds[:, 1])], axis=1)
            children.append(self._node(self.d, nb, parent))
        parent.children = children
        if self.d == 1:
            parent.left, parent.right = children
        for child in children:
            self.Sets.append(child)
            self._construct(child._bounds_np, levels - 1, child)


class CandidateSet:
    """Discrete candidate set for BO."""

    def __init__(self, points, device=None, dtype=torch.float32):
        self.points = as_tensor(points, device=resolve_device(device),
                                dtype=dtype)
        self.n, self.d = self.points.shape

    def get_points(self) -> torch.Tensor:
        return self.points

    def size(self) -> int:
        return self.n


class CandidateDiscreteSet(CandidateSet):
    """Discrete candidate set with removal/selection bookkeeping."""

    def __init__(self, points, device=None, dtype=torch.float32):
        super().__init__(points, device=device, dtype=dtype)
        self._active = np.ones(self.n, dtype=bool)

    def get_options_per_dim(self):
        pts = self.points.cpu().numpy()
        return [np.unique(pts[:, j]) for j in range(self.d)]

    def remove(self, idx):
        self._active[np.asarray(idx)] = False

    def get_active_points(self):
        idx = torch.as_tensor(np.where(self._active)[0],
                              device=self.points.device)
        return self.points[idx]
