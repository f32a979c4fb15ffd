"""Port parity: the rest of stpy_tpu_torch/linalg.py (`chol_recursive`,
`tri_solve_blocked_t`, `diag_block_invs`, `tri_solve_chunked`,
`solve_psd`, `chol_rank1_update`, `schur_complement_extend`) against
stpy_tpu/linalg.py on the CPU, the same numpy inputs from a seed, JAX in
x64 under `jax.jit`. Bars, relative to the largest entry of the JAX
result: float64 1e-10, float32 1e-5 (each package rounds its own f32
arithmetic). n = 300 with nb = 64 takes the pad path (300 is not a
multiple of 64); n = 256 does not. The port's one departure,
`chol_recursive`'s Schur update in float64 for an f32 factor, is held by
the factor's backward error: at most the JAX f32 factor's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import linalg as jl
from stpy_tpu_torch import linalg as tl

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

NB = 64
BARS = {np.float64: 1e-10, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def spd(n, seed=0, s2=1e-2):
    """An SE Gram (γ = 0.5) of n points in [-1, 1]³ plus s2·I."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, 3))
    sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.exp(-sq / (2 * 0.25)) + s2 * np.eye(n)


def both(a, dtype):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.as_tensor(a)


@pytest.mark.parametrize("n", [300, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_recursive_matches_jax(n, dtype):
    Kj, Kt = both(spd(n), dtype)
    Lj = jax.jit(jl.chol_recursive, static_argnums=1)(Kj, NB)
    Lt = tl.chol_recursive(Kt, nb=NB)
    assert Lt.dtype == TORCH[dtype]
    assert rel(Lt, Lj) < BARS[dtype]
    assert float(torch.triu(Lt, 1).abs().max()) == 0.0


def test_chol_recursive_f32_backward_error_is_at_most_jax():
    K = spd(1024).astype(np.float32)
    Lj = np.asarray(jax.jit(jl.chol_recursive, static_argnums=1)(
        jnp.asarray(K), 128), np.float64)
    Lt = tl.chol_recursive(torch.as_tensor(K), nb=128).double().numpy()
    K64 = K.astype(np.float64)

    def backward(L):
        return np.linalg.norm(K64 - L @ L.T) / np.linalg.norm(K64)

    # CPU: 2.44e-7 against the JAX factor's 3.32e-7 (entry by entry the
    # two f32 factors part by 1.0e-5 at this n, the JAX one's rounding)
    assert backward(Lt) <= backward(Lj)


def test_chol_recursive_fails_by_nans_as_jax():
    K = spd(300)
    K[200, 200] = -1.0                # indefinite: the leaf at 192 fails
    Lj = np.asarray(jax.jit(jl.chol_recursive, static_argnums=1)(
        jnp.asarray(K), NB))
    Lt = tl.chol_recursive(torch.as_tensor(K), nb=NB).numpy()
    assert not np.isfinite(Lt).all() and not np.isfinite(Lj).all()
    # the leaves before the failed one are the JAX package's
    assert rel(Lt[:192, :192], Lj[:192, :192]) < BARS[np.float64]


@pytest.mark.parametrize("n", [300, 256])
def test_tri_solve_blocked_t_matches_jax(n):
    rng = np.random.default_rng(1)
    L = np.linalg.cholesky(spd(n))
    B = rng.standard_normal((n, 7))
    Lj, Lt = both(L, np.float64)
    Bj, Bt = both(B, np.float64)
    Xj = jax.jit(jl.tri_solve_blocked_t, static_argnums=2)(Lj, Bj, NB)
    assert rel(tl.tri_solve_blocked_t(Lt, Bt, nb=NB), Xj) < 1e-10
    assert rel(L.T @ tl.tri_solve_blocked_t(Lt, Bt).numpy(), B) < 1e-10
    if n % NB == 0:
        # a shared leaf_inv (from the port's diag_block_invs) changes
        # nothing
        inv = tl.diag_block_invs(Lt, NB)
        assert rel(tl.tri_solve_blocked_t(Lt, Bt, nb=NB, leaf_inv=inv),
                   Xj) < 1e-10


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_diag_block_invs_matches_jax(dtype):
    Lj, Lt = both(np.linalg.cholesky(spd(320)), dtype)
    Dj = jax.jit(jl.diag_block_invs, static_argnums=1)(Lj, NB)
    Dt = tl.diag_block_invs(Lt, NB)
    assert Dt.shape == (5, NB, NB)
    assert rel(Dt, Dj) < BARS[dtype]


@pytest.mark.parametrize("k, chunk", [(1000, 128), (100, 128)])
@pytest.mark.parametrize("lower", [True, False])
def test_tri_solve_chunked_matches_jax(k, chunk, lower):
    rng = np.random.default_rng(2)
    L = np.linalg.cholesky(spd(200))
    T = L if lower else L.T
    B = rng.standard_normal((200, k))
    (Tj, Tt), (Bj, Bt) = both(T, np.float64), both(B, np.float64)
    Xj = jax.jit(jl.tri_solve_chunked, static_argnums=(2, 3))(
        Tj, Bj, chunk, lower)
    Xt = tl.tri_solve_chunked(Tt, Bt, chunk=chunk, lower=lower)
    assert rel(Xt, Xj) < 1e-10
    assert rel(T @ Xt.numpy(), B) < 1e-10


def test_solve_psd_matches_jax():
    rng = np.random.default_rng(3)
    K, b = spd(150), rng.standard_normal((150, 2))
    xj, rj = jax.jit(jl.solve_psd)(jnp.asarray(K), jnp.asarray(b))
    xt, rt = tl.solve_psd(torch.as_tensor(K), torch.as_tensor(b))
    assert rel(xt, xj) < 1e-10
    assert rel(rt.L, rj.L) < 1e-10
    assert bool(rt.ok) and bool(rj.ok)
    assert float(rt.jitter) == pytest.approx(float(rj.jitter), rel=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_rank1_update_matches_jax(dtype):
    rng = np.random.default_rng(4)
    L = np.linalg.cholesky(spd(120))
    v = 0.3 * rng.standard_normal(120)
    (Lj, Lt), (vj, vt) = both(L, dtype), both(v, dtype)
    Uj = jax.jit(jl.chol_rank1_update)(Lj, vj)
    Ut = tl.chol_rank1_update(Lt, vt)
    assert rel(Ut, Uj) < BARS[dtype]
    want = L @ L.T + np.outer(v, v)
    U = Ut.double().numpy()
    assert rel(U @ U.T, want) < BARS[dtype]
    assert rel(Lt, L) < BARS[dtype]      # the inputs are not modified


@pytest.mark.parametrize("floor", [False, True])
def test_schur_complement_extend_matches_jax(floor):
    rng = np.random.default_rng(5)
    K = spd(81)
    Kinv = np.linalg.inv(K[:80, :80])
    k_new, k_nn = K[:80, 80], K[80, 80]
    if floor:       # s = k_nn − k_newᵀ K⁻¹ k_new below 1e-12: the floor
        k_nn = k_new @ Kinv @ k_new + 1e-14
    Ej = jax.jit(jl.schur_complement_extend)(
        jnp.asarray(Kinv), jnp.asarray(k_new), jnp.asarray(k_nn))
    Et = tl.schur_complement_extend(torch.as_tensor(Kinv),
                                    torch.as_tensor(k_new),
                                    torch.as_tensor(k_nn))
    assert rel(Et, Ej) < 1e-10
    if not floor:
        assert rel(Et, np.linalg.inv(K)) < 1e-8
