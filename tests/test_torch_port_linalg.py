"""Port parity: the Cholesky and triangular-solve layer of stpy_tpu_torch
against stpy_tpu.

Both packages run in float64 on the CPU (LAPACK underneath both).
Tolerance: 1e-10 relative to the largest entry of the reference result —
the JAX blocked solves multiply by inverted diagonal blocks where the port
substitutes directly, so results agree to a few ulps times the condition
number (~1e4 here), not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu import linalg as jl
from stpy_tpu_torch import linalg as tl
from stpy_tpu_torch.config import default_jitter

from test_torch_port_gram_matvec import _FakeCuda
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def spd(n, seed, noise=1e-2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    return np.exp(-sq / (2 * 0.6 ** 2)) + noise * np.eye(n)


@pytest.fixture(scope="module")
def factor():
    K = spd(96, seed=0)
    return K, np.array(jl.safe_cholesky(jnp.asarray(K)).L)


def test_safe_cholesky_matches_jax_and_leaves_input_unchanged():
    K = spd(96, seed=0)
    Kt = torch.as_tensor(K)
    res = tl.safe_cholesky(Kt)
    want = jl.safe_cholesky(jnp.asarray(K))
    assert bool(res.ok) and bool(want.ok)
    assert rel_err(res.L.numpy(), want.L) <= RTOL
    assert float(res.jitter) == pytest.approx(float(want.jitter), rel=1e-12)
    assert np.array_equal(Kt.numpy(), K)


def test_safe_cholesky_ladder_escalates_like_jax():
    """An indefinite matrix whose smallest eigenvalue is −1e-9·scale fails
    the first rungs and succeeds once the jitter passes it."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    lam = np.linspace(1.0, 2.0, 40)
    lam[0] = -1e-9
    K = (Q * lam) @ Q.T
    res = tl.safe_cholesky(torch.as_tensor(K))
    want = jl.safe_cholesky(jnp.asarray(K))
    assert bool(res.ok) and bool(want.ok)
    assert float(res.jitter) == pytest.approx(float(want.jitter), rel=1e-12)
    assert float(res.jitter) > default_jitter(torch.float64) * np.mean(np.diag(K))
    assert rel_err(res.L.numpy(), want.L) <= RTOL


def test_safe_cholesky_reports_failure_without_raising():
    K = -np.eye(8)
    res = tl.safe_cholesky(torch.as_tensor(K), max_tries=3)
    assert not bool(res.ok)
    assert bool(torch.isnan(res.L).all())
    assert bool(jl.safe_cholesky(jnp.asarray(K), max_tries=3).ok) is False


def test_chol_jittered_matches_jax_and_nans_on_failure():
    K = spd(64, seed=2, noise=0.0)
    got = tl.chol_jittered(torch.as_tensor(K))
    assert rel_err(got.numpy(), jl.chol_jittered(jnp.asarray(K))) <= RTOL
    assert bool(torch.isnan(tl.chol_jittered(-torch.eye(4,
                                                          dtype=torch.float64))).all())


@pytest.mark.parametrize("width", [1, 40])
def test_cho_solve_blocked_matches_jax(factor, width):
    K, L = factor
    b = np.random.default_rng(3).standard_normal((96, width))
    got = tl.cho_solve_blocked(torch.as_tensor(L), torch.as_tensor(b))
    assert rel_err(got.numpy(), jl.cho_solve_blocked(jnp.asarray(L),
                                                      jnp.asarray(b))) <= RTOL
    got = tl.cho_solve(torch.as_tensor(L), torch.as_tensor(b))
    assert rel_err(got.numpy(), jl.cho_solve(jnp.asarray(L), jnp.asarray(b))) <= RTOL


@pytest.mark.parametrize("n", [96, 600])
def test_tri_solve_blocked_matches_jax(n):
    """n = 600 crosses the JAX package's 512 leaf, so its recursion runs."""
    K = spd(n, seed=4)
    L = np.linalg.cholesky(K)
    B = np.random.default_rng(5).standard_normal((n, 70))
    got = tl.tri_solve_blocked(torch.as_tensor(L), torch.as_tensor(B))
    want = jl.tri_solve_blocked(jnp.asarray(L), jnp.asarray(B))
    assert rel_err(got.numpy(), want) <= RTOL
    got = tl.tri_solve(torch.as_tensor(L), torch.as_tensor(B))
    assert rel_err(got.numpy(), jl.tri_solve(jnp.asarray(L), jnp.asarray(B))) <= RTOL


def test_logdet_from_chol_matches_jax(factor):
    _, L = factor
    got = float(tl.logdet_from_chol(torch.as_tensor(L)))
    assert got == pytest.approx(float(jl.logdet_from_chol(jnp.asarray(L))),
                                rel=1e-12)


def test_jitter_defaults_match_jax():
    from stpy_tpu.config import default_jitter as jax_default_jitter

    assert default_jitter(torch.float32) == jax_default_jitter(jnp.float32)
    assert default_jitter(torch.float64) == jax_default_jitter(jnp.float64)


@pytest.mark.parametrize("fast", [False, True])
def test_chol_dense_matches_jax_on_the_cpu(fast):
    """On the CPU both packages' `fast` branch is the LAPACK factor (the
    fast factorization is for the accelerator), so they agree at RTOL."""
    K = spd(96, seed=6)
    got = tl.chol_dense(torch.as_tensor(K), fast=fast)
    assert rel_err(got.numpy(), jl.chol_dense(jnp.asarray(K), fast=fast)) <= RTOL
    assert bool(torch.isnan(tl.chol_dense(-torch.eye(4, dtype=torch.float64),
                                          fast=fast)).all())


def test_safe_cholesky_fast_matches_jax_on_the_cpu():
    K = spd(96, seed=0)
    res = tl.safe_cholesky(torch.as_tensor(K), fast=True)
    want = jl.safe_cholesky(jnp.asarray(K), fast=True)
    assert bool(res.ok) and bool(want.ok)
    assert rel_err(res.L.numpy(), want.L) <= RTOL
    assert float(res.jitter) == pytest.approx(float(want.jitter), rel=1e-12)


def test_safe_cholesky_fast_ladder_escalates_like_jax():
    """The matrix of test_safe_cholesky_ladder_escalates_like_jax, through
    the isfinite test of the fast ladder: the same rungs fail, the same
    jitter succeeds, and K comes back unchanged."""
    rng = np.random.default_rng(1)
    Q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    lam = np.linspace(1.0, 2.0, 40)
    lam[0] = -1e-9
    K = (Q * lam) @ Q.T
    Kt = torch.as_tensor(K.copy())
    res = tl.safe_cholesky(Kt, fast=True)
    want = jl.safe_cholesky(jnp.asarray(K), fast=True)
    assert bool(res.ok) and bool(want.ok)
    assert float(res.jitter) == pytest.approx(float(want.jitter), rel=1e-12)
    assert float(res.jitter) > default_jitter(torch.float64) * np.mean(np.diag(K))
    assert rel_err(res.L.numpy(), want.L) <= RTOL
    assert np.array_equal(Kt.numpy(), K)
    fail = tl.safe_cholesky(-torch.eye(8, dtype=torch.float64), max_tries=2,
                            fast=True)
    assert not bool(fail.ok) and bool(torch.isnan(fail.L).all())


def test_chol_dense_takes_the_fast_path_where_the_jax_package_does(monkeypatch):
    """`fast`, n ≥ 4096 and a tensor on the accelerator (stpy_tpu/linalg.py:61);
    everywhere else the default factor."""
    calls = []
    monkeypatch.setattr(tl, "chol_blocked_syrk",
                        lambda K: calls.append(("fast", K.shape[0])))
    monkeypatch.setattr(tl, "_cholesky",
                        lambda K: calls.append(("default", K.shape[0])))
    for n, cuda, fast in ((4096, True, True), (4095, True, True),
                          (4096, True, False), (4096, False, True)):
        K = torch.empty((n, n), dtype=torch.float32)
        tl.chol_dense(K.as_subclass(_FakeCuda) if cuda else K, fast=fast)
    assert calls == [("fast", 4096), ("default", 4095), ("default", 4096),
                     ("default", 4096)]


def test_fast_factor_on_the_card_is_float32_only():
    K = torch.eye(8, dtype=torch.float64).as_subclass(_FakeCuda)
    with pytest.raises(TypeError, match="float32"):
        tl.chol_dense(K, fast=True)
    with pytest.raises(TypeError, match="float32"):
        tl.safe_cholesky(K, fast=True)
