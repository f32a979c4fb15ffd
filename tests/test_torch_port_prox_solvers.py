"""Port parity: the first-order constrained solvers of
stpy_tpu_torch/opt/prox.py (`projected_gradient`, `projected_fista`,
`fista_prox_backtracking`, `fista_backtracking`) against stpy_tpu/opt on
the CPU, with the bars of tests/test_torch_port_prox.py (which holds the
projections, proxes, bisection and Newton): each solver's iterate after
1, 2 and 5 iterations within 1e-12 relative, its converged x within 1e-10
with the same iteration count and `converged` flag.
"""

import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.opt import prox as jp
from stpy_tpu_torch.opt import prox as tp

from test_torch_port_prox import SOLVERS, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("name", list(SOLVERS))
@pytest.mark.parametrize("max_iter", [1, 2, 5])
def test_solver_iterates_match_jax(name, max_iter):
    t = SOLVERS[name](tp, torch, max_iter)
    j = SOLVERS[name](jp, jnp, max_iter)
    assert rel(t.x, j.x) <= 1e-12
    assert t.iterations == int(j.iterations)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_converged_fit_matches_jax(name):
    t = SOLVERS[name](tp, torch, 5000)
    j = SOLVERS[name](jp, jnp, 5000)
    assert t.converged == bool(j.converged)
    assert t.iterations == int(j.iterations)
    assert rel(t.x, j.x) <= 1e-10
    assert abs(float(t.value) - float(j.value)) <= 1e-10 * abs(float(j.value))
