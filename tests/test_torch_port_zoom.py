"""Port parity: L-BFGS with the zoom (strong-Wolfe) line search,
`stpy_tpu_torch.opt.minimize_lbfgs(linesearch="zoom")`, against
`stpy_tpu.opt.lbfgs.minimize_lbfgs` (optax's `scale_by_zoom_linesearch`)
on the CPU.

The same numpy starting points go through both packages, JAX in x64 and
torch in float64: a Rosenbrock function, a Huber-loss objective in an
alpha of 48 entries (the robust GP's `_loss_objective`), and a function
that leaves its domain (NaN) on long steps, where the search must fall
back to a safe step. Tolerances: the iterate after each of
max_iter = 1…6 within 1e-10 relative and equal iteration counts; the
converged x within 1e-8 relative and the value within 1e-12, both runs
converged, with equal iteration counts except on the Huber objective
(388 against 386: ~400 iterations through its kink amplify the last
bit, and the final x still agree to 1.1e-10).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.opt import lbfgs as jl
from stpy_tpu_torch.opt import minimize_lbfgs

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

STEP_RTOL = 1e-10

_rng = np.random.default_rng(11)
_K = (lambda a: a @ a.T / 48 + 0.1 * np.eye(48))(_rng.standard_normal((48, 48)))
_Y = _rng.standard_normal(48) + 5.0 * (_rng.uniform(size=48) < 0.1)


def rosen(lib):
    return lambda v: lib.sum(100 * (v[1:] - v[:-1] ** 2) ** 2
                             + (1 - v[:-1]) ** 2)


def huber(lib):
    K, y, delta = lib.asarray(_K), lib.asarray(_Y), 1.35

    def obj(a):
        r = (K @ a - y) / 0.3
        m = lib.abs(r)
        hub = lib.where(m <= delta, 0.5 * m ** 2, delta * (m - 0.5 * delta))
        return lib.sum(hub) + 0.5 * a @ (K @ a)

    return obj


def log_barrier(lib):
    # NaN past x = 2: a unit step from 0 along −g lands outside at first
    return lambda v: lib.sum(-lib.log(2.0 - v) + 0.5 * (v - 1.9) ** 2
                             * 40.0)


CASES = {"rosenbrock": (rosen, np.array([-1.2, 1.0, -0.5, 0.8])),
         "huber": (huber, np.zeros(48)),
         "barrier": (log_barrier, np.zeros(3))}


def both(case, **kw):
    fn, x0 = CASES[case]
    j = jl.minimize_lbfgs(fn(jnp), jnp.asarray(x0), **kw)
    t = minimize_lbfgs(fn(torch), torch.as_tensor(x0), **kw)
    return j, t


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("max_iter", [1, 2, 3, 6])
def test_zoom_iterates_match_jax(case, max_iter):
    j, t = both(case, max_iter=max_iter)
    assert rel(t.x.numpy(), j.x) <= STEP_RTOL
    assert t.iterations == int(j.iterations)


@pytest.mark.parametrize("case", list(CASES))
def test_zoom_converged_fit_matches_jax(case):
    j, t = both(case, max_iter=500, tol=1e-9)
    assert t.converged and bool(j.converged)
    assert rel(t.x.numpy(), j.x) <= 1e-8
    assert abs(float(t.value) - float(j.value)) <= 1e-12 * abs(float(j.value))
    if case != "huber":
        assert t.iterations == int(j.iterations)


def test_zoom_is_the_default_and_ignores_the_backtracking_step_count():
    # the JAX package passes max_linesearch_steps to backtracking only:
    # zoom keeps optax's 20 whatever the caller says
    fn, x0 = CASES["rosenbrock"]
    a = minimize_lbfgs(fn(torch), torch.as_tensor(x0), max_iter=30)
    b = minimize_lbfgs(fn(torch), torch.as_tensor(x0), max_iter=30,
                       linesearch="zoom", max_linesearch_steps=2)
    assert torch.equal(a.x, b.x) and a.iterations == b.iterations
