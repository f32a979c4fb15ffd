"""Port parity: parallel/blocked.py (`blocked_cholesky`, `chol_sharded`,
`chol_sharded_rec`, `DistributedExactGP` with each factorization) on gloo
ranks against the JAX package on a mesh of the conftest's virtual CPU
devices.

The ranks run once for the module (tests/torch_ranks.py: spawned, float64,
worlds 2 and 4). n = 250 divides neither nb = 64 nor the worlds, so every
padding path runs (the padded n is 256), and the panels GP is refit at
n = 150 (tests/test_blocked_cholesky.py:81). Tolerance, in float64: 1e-10
absolute on the factors (entries up to ~20), the means and the stds.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stpy_tpu.kernels import KernelFunction
from stpy_tpu.parallel import blocked as jb

import torch_ranks as tr
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
ATOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test; the JAX side runs while the
    ranks do, and the first read of a world joins them."""
    ranks = tr.Ranks("blocked_cases", WORLDS,
                     tmp_path_factory.mktemp("blocked_ranks"))
    yield ranks
    ranks.close()


def jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]), ("tp",))


def replicated(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


def close(got, want):
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= ATOL


@pytest.fixture(scope="module")
def jax_blocked():
    return np.asarray(jax.jit(lambda K: jb.blocked_cholesky(K, nb=tr.BLOCKED_NB))(
        jnp.asarray(tr.spd(256, 0))))


def test_blocked_cholesky_on_one_device_matches_jax(jax_blocked):
    from stpy_tpu_torch.parallel import blocked_cholesky

    close(blocked_cholesky(tr.t64(tr.spd(256, 0)), nb=tr.BLOCKED_NB).numpy(),
          jax_blocked)


@pytest.mark.parametrize("world", WORLDS)
def test_blocked_cholesky_over_a_row_sharded_dtensor(ranks, jax_blocked,
                                                     world):
    close(replicated(ranks[world], "blocked_dtensor"), jax_blocked)


@pytest.mark.parametrize("world", WORLDS)
def test_chol_sharded_pads_and_matches_jax(ranks, jax_refs, world):
    want = jax_refs["chol_sharded", world]
    assert tuple(ranks[world][0]["chol_sharded_shape"]) == (tr.BLOCKED_N,) * 2
    close(replicated(ranks[world], "chol_sharded"), want)


@pytest.mark.parametrize("world", WORLDS)
def test_chol_sharded_rec_matches_jax(ranks, jax_refs, world):
    want = jax_refs["chol_sharded_rec", world]
    close(replicated(ranks[world], "chol_sharded_rec"), want)


def jax_gp(world, fac, n=tr.BLOCKED_N, seed=2):
    """The JAX posterior of `fac`. Its "panels" Gram builder raises where a
    padded fit's per-device rows exceed the panel width: the diagonal
    values (nl,) broadcast against an (nl, nbe) strip
    (stpy_tpu/parallel/blocked.py:474-484; at 2 devices, 128 rows and panels
    of 64). So at 2 devices the port's panels are held to the JAX masked
    factorization, the same L."""
    if fac == "panels" and world == 2:
        fac = "masked"
    x, y, xt = tr.blocked_data(n, seed)
    k = KernelFunction(kernel_name="squared_exponential", gamma=0.5, d=2)
    gp = jb.DistributedExactGP(k, s=0.1, mesh=jax_mesh(world),
                               nb=tr.BLOCKED_NB, factorization=fac)
    gp.fit_gp(jnp.asarray(x), jnp.asarray(y))
    return gp.mean_std(jnp.asarray(xt if n == tr.BLOCKED_N else x[:10]))


@pytest.fixture(scope="module")
def jax_refs(ranks):
    """Every JAX factor and posterior of the module, computed while the
    ranks run."""
    K = jnp.asarray(tr.spd(tr.BLOCKED_N, 1))
    out = {}
    for world in WORLDS:
        mesh = jax_mesh(world)
        out["chol_sharded", world] = jb.chol_sharded(K, mesh,
                                                     nb=tr.BLOCKED_NB)
        out["chol_sharded_rec", world] = jb.chol_sharded_rec(
            K, mesh, nb=tr.BLOCKED_NB)
        for fac in tr.FACTORIZATIONS:
            out[fac, world] = jax_gp(world, fac)
        out["refit", world] = jax_gp(world, "panels", tr.BLOCKED_REFIT_N,
                                     seed=9)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fac", tr.FACTORIZATIONS)
def test_distributed_exact_gp_matches_jax(ranks, jax_refs, fac, world):
    """Mean and std of each factorization against the JAX one; each rank
    holds (n_padded/p, n_padded) of L."""
    mu, sd = jax_refs[fac, world]
    res = ranks[world]
    close(replicated(res, f"{fac}_mu"), mu)
    close(replicated(res, f"{fac}_sd"), sd)
    assert tuple(res[0][f"{fac}_L_local_shape"]) == (256 // world, 256)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_gp_refit_at_a_second_n(ranks, jax_refs, world):
    mu, sd = jax_refs["refit", world]
    close(replicated(ranks[world], "refit_mu"), mu)
    close(replicated(ranks[world], "refit_sd"), sd)
