"""Port parity: the minimisers of stpy_tpu_torch/opt (damped Newton,
L-BFGS with the batched and the backtracking line search) on the negative
log evidence of a 64-point SE GP in (log γ, log s), and the default zoom
L-BFGS on a Rosenbrock function, against stpy_tpu/opt on the CPU.

The same numpy starting points go through both packages, JAX in x64 and
torch in float64, with the bars of tests/test_torch_port_lbfgs.py: the
iterate after each of max_iter = 1…5 within 1e-10 relative, the
converged x within 1e-6, equal iteration counts and `converged` flags.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.opt import lbfgs as jl
from stpy_tpu_torch.opt import minimize_lbfgs

from test_torch_port_lbfgs import (
    FINAL_RTOL, METHODS, STEP_RTOL, rel, rosen_jax, rosen_torch, run,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("problem", ["evidence"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("max_iter", [1, 2, 3, 4, 5])
def test_iterates_match_jax_step_by_step(method, problem, max_iter):
    a, b = run(method, problem, max_iter)
    assert b.iterations == int(a.iterations) == max_iter
    assert rel(a.x, b.x) <= STEP_RTOL
    assert float(b.value) == pytest.approx(float(a.value), rel=STEP_RTOL)


@pytest.mark.parametrize("problem", ["evidence"])
@pytest.mark.parametrize("method", METHODS)
def test_converged_fit_matches_jax(method, problem):
    a, b = run(method, problem, 60)
    assert rel(a.x, b.x) <= FINAL_RTOL
    assert b.iterations == int(a.iterations) < 60
    assert b.converged == bool(a.converged)


def test_zoom_line_search_matches_jax():
    # the JAX default line search, once a raise here: the converged
    # Rosenbrock fit from the same start (tests/test_torch_port_zoom.py
    # holds its iterates step by step)
    x0 = np.array([-1.2, 1.0, 0.5])
    t = minimize_lbfgs(rosen_torch, torch.as_tensor(x0), max_iter=200)
    j = jl.minimize_lbfgs(rosen_jax, jnp.asarray(x0), max_iter=200)
    assert t.converged and bool(j.converged)
    assert t.iterations == int(j.iterations)
    assert np.max(np.abs(t.x.numpy() - np.asarray(j.x))) <= FINAL_RTOL
