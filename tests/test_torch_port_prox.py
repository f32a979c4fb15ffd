"""Port parity: stpy_tpu_torch/opt/prox.py (projections, proxes and the
first-order constrained solvers) and opt/scalar.py's `bisection` and
`newton_1d` against stpy_tpu/opt on the CPU.

The same numpy inputs (seeded) go through both packages, JAX in x64 and
torch in float64. Tolerances: the projections and proxes within 1e-14
absolute; each solver's iterate after 1, 2 and 5 iterations within 1e-12
relative, its converged x within 1e-10 relative with the same iteration
count and `converged` flag; bisection and Newton within 1e-14.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.opt import prox as jp
from stpy_tpu.opt import scalar as js
from stpy_tpu_torch.opt import prox as tp
from stpy_tpu_torch.opt import scalar as ts

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

_rng = np.random.default_rng(3)
_X = _rng.standard_normal(12)
_Q = (lambda a: a @ a.T / 12 + 0.05 * np.eye(12))(_rng.standard_normal((12, 12)))
_B = _rng.standard_normal(12)
_GROUPS = [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9, 10, 11]]
_LIP = float(np.linalg.eigvalsh(_Q)[-1])


def close(t, j, atol=1e-14):
    return np.max(np.abs(np.asarray(t) - np.asarray(j))) <= atol


def rel(t, j):
    t, j = np.asarray(t), np.asarray(j)
    return np.max(np.abs(t - j)) / max(np.max(np.abs(j)), 1e-300)


PROJECTIONS = {
    "prox_box": lambda m, x: m.prox_box(x, -0.5, 0.7),
    "prox_l1": lambda m, x: m.prox_l1(x, 0.4),
    "prox_group_l2": lambda m, x: m.prox_group_l2(x, 0.9, _GROUPS),
    "project_simplex": lambda m, x: m.project_simplex(x),
    "project_simplex_far": lambda m, x: m.project_simplex(10.0 * x + 3.0),
    "project_l2_ball": lambda m, x: m.project_l2_ball(x, 1.5),
    "project_l2_ball_inside": lambda m, x: m.project_l2_ball(0.1 * x, 1.5),
}


@pytest.mark.parametrize("name", list(PROJECTIONS))
def test_projections_match_jax(name):
    f = PROJECTIONS[name]
    assert close(f(tp, torch.as_tensor(_X)), f(jp, jnp.asarray(_X)))


def quad(lib):
    Q, b = lib.asarray(_Q), lib.asarray(_B)
    return lambda x: 0.5 * x @ (Q @ x) - b @ x


SOLVERS = {
    "projected_gradient": lambda m, lib, it: m.projected_gradient(
        quad(lib), lib.asarray(np.zeros(12)),
        lambda x: m.prox_box(x, -0.3, 0.3), lipschitz=_LIP, max_iter=it),
    "projected_gradient_lr": lambda m, lib, it: m.projected_gradient(
        quad(lib), lib.asarray(np.zeros(12)), m.project_l2_ball, lr=0.05,
        max_iter=it),
    "projected_fista": lambda m, lib, it: m.projected_fista(
        quad(lib), lib.asarray(np.zeros(12)),
        lambda x: m.prox_box(x, -0.3, 0.3), lipschitz=_LIP, max_iter=it),
    "fista_backtracking": lambda m, lib, it: m.fista_backtracking(
        quad(lib), lib.asarray(np.zeros(12)), m.project_simplex,
        max_iter=it),
    "fista_prox_backtracking": lambda m, lib, it: m.fista_prox_backtracking(
        quad(lib), lib.asarray(np.zeros(12)),
        lambda x, step: m.prox_group_l2(x, 0.2 * step, _GROUPS),
        max_iter=it),
}


def test_bisection_matches_jax_elementwise():
    c = np.array([0.1, 0.5, 2.0, 30.0])
    a, b = np.zeros(4), np.full(4, 3.0)
    t = ts.bisection(lambda v: v ** 3 - torch.as_tensor(c),
                     torch.as_tensor(a), torch.as_tensor(b), iters=60)
    j = js.bisection(lambda v: v ** 3 - jnp.asarray(c), jnp.asarray(a),
                     jnp.asarray(b), iters=60)
    assert close(t, j)
    # no sign change on the last entry: both return the same end point
    assert float(t[-1]) == float(j[-1]) == pytest.approx(3.0, abs=1e-12)


@pytest.mark.parametrize("x0,iters", [(1.0, 50), (3.0, 4)])
def test_newton_1d_matches_jax(x0, iters):
    t = ts.newton_1d(lambda v: torch.cos(v) - v ** 3, x0, iters=iters)
    j = js.newton_1d(lambda v: jnp.cos(v) - v ** 3, x0, iters=iters)
    assert close(t, j)
