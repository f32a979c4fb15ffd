"""Port parity: stpy_tpu_torch/opt/{frank_wolfe,custom}.py against
stpy_tpu/opt on the CPU.

The same numpy inputs (seeded) go through both packages, JAX in x64 and
torch in float64. Tolerances: the simplex steps within 1e-10 relative;
the iterative solvers (`minimize_on_simplex` over 300 steps, both
methods; `newton_solve`; the trace-regression recovery's L-BFGS) within
1e-6 relative. `minimize_on_simplex` also takes a closed-form gradient,
held to autograd's. The regularizers and constraints are in
tests/test_torch_port_regularization.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.opt import custom as jc
from stpy_tpu.opt import frank_wolfe as jfw
from stpy_tpu_torch.opt import custom as tc
from stpy_tpu_torch.opt import frank_wolfe as tfw
from stpy_tpu_torch import regularization as tr

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
ITER = 1e-6

_rng = np.random.default_rng(11)
_P = np.array([0.1, 0.25, 0.05, 0.4, 0.2])
_Qm = (lambda a: a @ a.T / 5 + 0.2 * np.eye(5))(_rng.standard_normal((5, 5)))
_THETA = _rng.standard_normal(6)
_GROUPS = [[0, 1], [2, 3, 4], [5]]
_NESTED = [[0, 1, 2, 3], [2, 3], [5]]


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def simplex_objective(m):
    """(x − p)ᵀQ(x − p) + Σ x log x, and its gradient in closed form."""
    lib = torch if m is tfw else jnp
    Q, p = (t(_Qm), t(_P)) if m is tfw else (jnp.asarray(_Qm), jnp.asarray(_P))

    def f(x):
        r = x - p
        return r @ (Q @ r) + lib.sum(x * lib.log(x))

    def g(x):
        return 2.0 * Q @ (x - p) + lib.log(x) + 1.0

    return f, g


@pytest.mark.parametrize("method", ["eg", "fw"])
def test_minimize_on_simplex_matches_jax(method):
    fj, _ = simplex_objective(jfw)
    ft, gt = simplex_objective(tfw)
    x0 = np.ones(5) / 5
    xj, vj = jfw.minimize_on_simplex(fj, jnp.asarray(x0), steps=300, eta=0.3,
                                     method=method)
    xt, vt = tfw.minimize_on_simplex(ft, t(x0), steps=300, eta=0.3,
                                     method=method)
    assert rel(xt, xj) < ITER and rel(vt, vj) < ITER
    # the closed-form gradient gives autograd's iterates
    xg, vg = tfw.minimize_on_simplex(ft, t(x0), steps=300, eta=0.3,
                                     method=method, grad=gt)
    assert rel(xg, xt) < 1e-12 and rel(vg, vt) < 1e-12
    if method == "eg":
        # the JAX package's own case (tests/test_mkl_and_misc.py)
        p = t([0.2, 0.3, 0.5])
        x, _ = tfw.minimize_on_simplex(lambda x: torch.sum((x - p) ** 2),
                                       torch.ones(3, dtype=torch.float64) / 3,
                                       steps=500, eta=0.5)
        assert np.allclose(x.numpy(), p.numpy(), atol=1e-3)


def test_simplex_steps_match_jax():
    g, x = _rng.standard_normal(5), np.array([0.3, 0.2, 0.1, 0.25, 0.15])
    for t_ in (0.0, 3.0):
        assert rel(tfw.frank_wolfe_step(t(g), t(x), t_),
                   jfw.frank_wolfe_step(jnp.asarray(g), jnp.asarray(x),
                                        t_)) < DET
    assert rel(tfw.exponentiated_gradient_step(t(g), t(x), 0.7),
               jfw.exponentiated_gradient_step(jnp.asarray(g), jnp.asarray(x),
                                               0.7)) < DET


def test_newton_solve_matches_jax():
    """A 3-D monotone root; autograd's Jacobian and a closed form."""
    c = np.array([1.0, -0.5, 2.0])

    def field(lib):
        cc = lib.asarray(c) if lib is jnp else t(c)

        def f(x):
            return x**3 + x + 0.2 * lib.stack([x[1], x[2], x[0]]) - cc
        return f

    def jac(x):
        z = torch.zeros_like(x[0])
        return torch.diag(3 * x**2 + 1) + 0.2 * torch.stack([
            torch.stack([z, z + 1, z]), torch.stack([z, z, z + 1]),
            torch.stack([z + 1, z, z])])

    x0 = np.array([0.5, 0.5, 0.5])
    xj = jc.newton_solve(field(jnp), jnp.asarray(x0), eps=1e-14)
    xt = tc.newton_solve(field(torch), t(x0), eps=1e-14)
    xc = tc.newton_solve(field(torch), t(x0), eps=1e-14, grad=jac)
    assert rel(xt, xj) < ITER and rel(xc, xj) < ITER
    assert float(torch.max(torch.abs(field(torch)(xt)))) < 1e-6


def test_greedy_and_trace_regression_recovery_match_jax():
    ground = _rng.standard_normal((7, 3))
    base = _rng.standard_normal((4, 3))
    fun_j = lambda s: jnp.linalg.slogdet(s.T @ s + jnp.eye(3))[1]
    fun_t = lambda s: torch.linalg.slogdet(s.T @ s + torch.eye(3,
                                           dtype=torch.float64))[1]
    for minimize in (True, False):
        assert tc.greedy_per_step(
            fun_t, lambda e: torch.cat([t(base), e]), t(ground), minimize) == \
            jc.greedy_per_step(fun_j, lambda e: jnp.concatenate(
                [jnp.asarray(base), e]), jnp.asarray(ground), minimize)
    d = 3
    Y = _rng.standard_normal((d, 1))
    Z = Y @ Y.T
    Xs = [(lambda a: a + a.T)(_rng.standard_normal((d, d))) for _ in range(8)]
    b = np.array([np.trace(X @ Z) for X in Xs])
    Zj = jc.matrix_recovery_hermitian_trace_regression(
        [jnp.asarray(X) for X in Xs], jnp.asarray(b), max_iter=300)
    Zt = tc.matrix_recovery_hermitian_trace_regression(Xs, b, max_iter=300,
                                                       device="cpu")
    assert rel(Zt, Zj) < ITER


def test_entry_points_default_to_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.minimize_on_simplex(lambda x: torch.sum(x * x), [0.5, 0.5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.LinearConstraint(np.eye(2))
    x, _ = tfw.minimize_on_simplex(lambda x: torch.sum(x * x), [0.3, 0.7],
                                   steps=300, eta=0.5, device="cpu")
    assert x.device.type == "cpu"
    assert np.allclose(x.numpy(), [0.5, 0.5], atol=1e-3)
    assert tr.LinearConstraint(np.eye(2), device="cpu").A.device.type == "cpu"
