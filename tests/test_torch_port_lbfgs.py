"""Port parity: the minimisers of stpy_tpu_torch/opt (damped Newton, L-BFGS
with the batched and the backtracking line search, the bijectors, golden
section) against stpy_tpu/opt on the CPU.

The same numpy starting points go through both packages, JAX in x64 and
torch in float64, on a Rosenbrock function (the negative log evidence of a
64-point SE GP in (log γ, log s), and the default zoom line search, are in
tests/test_torch_port_lbfgs_evidence.py). Tolerances: the iterate after each of
max_iter = 1…5 within 1e-10 relative, the converged x within 1e-6, equal
iteration counts and `converged` flags; the bijectors within 1e-14.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.linalg import chol_jittered as jax_chol, cho_solve as jax_cho
from stpy_tpu.linalg import logdet_from_chol as jax_logdet
from stpy_tpu.opt import lbfgs as jl
from stpy_tpu.ops.pallas_gram import gram_se as jax_gram_se
from stpy_tpu.opt.scalar import golden_section as jax_golden
from stpy_tpu_torch.linalg import chol_jittered, cho_solve, logdet_from_chol
from stpy_tpu_torch.opt import (
    golden_section, make_box_bijector, make_positive_bijector,
    minimize_lbfgs, minimize_newton_small,
)
from stpy_tpu_torch.ops.gram import gram_se

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

STEP_RTOL, FINAL_RTOL = 1e-10, 1e-6
METHODS = ("newton", "batched", "backtracking")

_rng = np.random.default_rng(5)
_X = _rng.uniform(-1, 1, (64, 1))
_Y = np.sin(4 * _X) + 0.1 * _rng.standard_normal((64, 1))


def rosen_jax(v):
    return jnp.sum(100 * (v[1:] - v[:-1] ** 2) ** 2 + (1 - v[:-1]) ** 2)


def rosen_torch(v):
    return torch.sum(100 * (v[1:] - v[:-1] ** 2) ** 2 + (1 - v[:-1]) ** 2)


def evidence_jax(t):
    x, y = jnp.asarray(_X), jnp.asarray(_Y)
    K = jax_gram_se(x, x, jnp.exp(t[0]))
    K = 0.5 * (K + K.T) + jnp.eye(64) * jnp.exp(t[1]) ** 2
    L = jax_chol(K)
    return 0.5 * (y.T @ jax_cho(L, y))[0, 0] + 0.5 * jax_logdet(L)


def evidence_torch(t):
    x, y = torch.as_tensor(_X), torch.as_tensor(_Y)
    K = gram_se(x, x, torch.exp(t[0]))
    K = 0.5 * (K + K.T) + torch.eye(64, dtype=K.dtype) * torch.exp(t[1]) ** 2
    L = chol_jittered(K)
    return 0.5 * (y.T @ cho_solve(L, y))[0, 0] + 0.5 * logdet_from_chol(L)


PROBLEMS = {
    "rosenbrock": (rosen_jax, rosen_torch, np.array([-1.2, 1.0, -0.5, 0.8])),
    "evidence": (evidence_jax, evidence_torch, np.array([0.8, -1.0])),
}


def run(method, problem, max_iter):
    fj, ft, x0 = PROBLEMS[problem]
    if method == "newton":
        x0 = x0[:2]
        kw = dict(max_iter=max_iter, rtol=1e-5, xtol=1e-6)
        a = jl.minimize_newton_small(fj, jnp.asarray(x0), **kw)
        b = minimize_newton_small(ft, torch.tensor(x0), **kw)
    else:
        kw = dict(max_iter=max_iter, linesearch=method, rtol=1e-5, xtol=1e-6,
                  max_linesearch_steps=12)
        a = jl.minimize_lbfgs(fj, jnp.asarray(x0), **kw)
        b = minimize_lbfgs(ft, torch.tensor(x0), **kw)
    return a, b


def rel(a, b):
    a = np.asarray(a)
    return float(np.max(np.abs(a - b.numpy()) / np.abs(a)))


@pytest.mark.parametrize("problem", ["rosenbrock"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("max_iter", [1, 2, 3, 4, 5])
def test_iterates_match_jax_step_by_step(method, problem, max_iter):
    a, b = run(method, problem, max_iter)
    assert b.iterations == int(a.iterations) == max_iter
    assert rel(a.x, b.x) <= STEP_RTOL
    assert float(b.value) == pytest.approx(float(a.value), rel=STEP_RTOL)


@pytest.mark.parametrize("problem", ["rosenbrock"])
@pytest.mark.parametrize("method", METHODS)
def test_converged_fit_matches_jax(method, problem):
    a, b = run(method, problem, 60)
    assert rel(a.x, b.x) <= FINAL_RTOL
    assert b.iterations == int(a.iterations) < 60
    assert b.converged == bool(a.converged)


def test_step_clip_bounds_the_iterates_as_jax_does():
    fj, ft, x0 = PROBLEMS["rosenbrock"]
    kw = dict(max_iter=6, linesearch="batched", max_linesearch_steps=12,
              step_clip=1.1)
    a = jl.minimize_lbfgs(fj, jnp.asarray(x0), **kw)
    b = minimize_lbfgs(ft, torch.tensor(x0), **kw)
    assert float(b.x.abs().max()) <= 1.1
    assert rel(a.x, b.x) <= STEP_RTOL


def test_bijectors_match_jax():
    p = np.array([0.03, 0.7, 2.5, 11.0])
    r = np.array([-3.0, -0.2, 0.4, 5.0])
    for jb, tb in ((jl.make_positive_bijector(2.0), make_positive_bijector(2.0)),
                   (jl.make_box_bijector(0.01, 12.0),
                    make_box_bijector(0.01, 12.0))):
        for k, v in ((0, r), (1, p)):
            want = np.asarray(jb[k](jnp.asarray(v)))
            got = tb[k](torch.tensor(v)).numpy()
            assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-14


def test_golden_section_matches_jax():
    want = jax_golden(lambda t: (t - 0.3) ** 2 + jnp.sin(3 * t), -2.0, 2.0,
                      iters=60)
    got = golden_section(lambda t: (t - 0.3) ** 2 + torch.sin(3 * t),
                         torch.tensor(-2.0, dtype=torch.float64),
                         torch.tensor(2.0, dtype=torch.float64), iters=60)
    assert float(got) == pytest.approx(float(want), rel=1e-14)
