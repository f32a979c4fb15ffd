"""Port parity: parallel/data.py (`host_sharded`, `HostShardedLoader`,
`streamed_feature_stats`, `fit_feature_gp_sharded`) on gloo ranks against
the JAX package on a mesh of the conftest's virtual CPU devices.

The ranks run once for the module (tests/torch_ranks.py: spawned, float64,
worlds 2 and 4). A JAX process is a host; a port process is a rank, so each
rank loads its own contiguous partition of the rows and a global batch of
64 rows is 64/p rows of each. The JAX loader is fed the same global batches
in the same order (`torch_ranks.global_batches`). Tolerances, in float64:
assembled rows and batches bit for bit; the sufficient statistics 1e-12 of
their largest entry (the sums run in another order); the fitted posterior
1e-8 (tests/test_host_sharded_data.py's bar), against JAX and against the
port's in-memory fit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stpy_tpu.embeddings import HermiteEmbedding
from stpy_tpu.models import KernelizedFeatures
from stpy_tpu.parallel import data as jdata

import torch_ranks as tr
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
STATS_RTOL = 1e-12
FIT_ATOL = 1e-8


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test; the JAX side runs while the
    ranks do, and the first read of a world joins them."""
    ranks = tr.Ranks("data_cases", WORLDS,
                     tmp_path_factory.mktemp("data_ranks"))
    yield ranks
    ranks.close()


def jax_mesh(world):
    return Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("dp", "tp"))


def jax_loader(x, y, world):
    xg = tr.global_batches(x, world, tr.FEATURE_BATCH)
    yg = tr.global_batches(y, world, tr.FEATURE_BATCH)
    return jdata.HostShardedLoader(lambda lo, hi: (xg[lo:hi], yg[lo:hi]),
                                   n_local=xg.shape[0],
                                   batch_size=tr.FEATURE_BATCH,
                                   mesh=jax_mesh(world))


def replicated(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_host_sharded_assembles_the_rank_rows(ranks, world):
    x, _ = tr.feature_data(200, d=2, seed=3)
    want = np.asarray(jdata.host_sharded(x, jax_mesh(world), "tp"))
    np.testing.assert_array_equal(replicated(ranks[world], "host_full"), want)
    for r, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["host_local"],
                                      tr.partition(x, world, r))


@pytest.mark.parametrize("world", WORLDS)
def test_loader_yields_the_global_batches_in_order(ranks, world):
    x, y = tr.feature_data(200, d=2, seed=3)
    batches = list(jax_loader(x, y, world))
    res = ranks[world]
    assert tuple(replicated(res, "n_batches")) == (len(batches),) * 2 == (3, 3)
    for key, i in (("batch_x", 0), ("batch_y", 1)):
        np.testing.assert_array_equal(
            replicated(res, key),
            np.concatenate([np.asarray(b[i]) for b in batches]))


@pytest.mark.parametrize("world", WORLDS)
def test_streamed_stats_match_jax_and_the_rows_in_memory(ranks, world):
    x, y = tr.feature_data()
    emb = HermiteEmbedding(gamma=0.5, m=64, d=1)
    V_j, b_j = jdata.streamed_feature_stats(emb.embed, jax_loader(x, y, world),
                                            emb.get_m())
    model = tr.feature_model()
    Q = model.embed(tr.t64(x)).numpy()
    res = ranks[world]
    for key, want_j, want in (("stats_V", V_j, Q.T @ Q),
                              ("stats_b", b_j, Q.T @ y)):
        got = replicated(res, key)
        for ref in (np.asarray(want_j), want):
            assert np.max(np.abs(got - ref)) <= STATS_RTOL * np.max(
                np.abs(ref)), key


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_jax_and_the_in_memory_fit(ranks, world):
    x, y = tr.feature_data()
    xt = np.linspace(-1, 1, 32)[:, None]
    emb = HermiteEmbedding(gamma=0.5, m=64, d=1)
    F = KernelizedFeatures(embedding=emb, m=emb.get_m(), s=0.05, lam=1.0,
                           primal=True, d=1)
    jdata.fit_feature_gp_sharded(F, jax_loader(x, y, world))
    mu_j, sd_j = (np.asarray(a) for a in F.mean_std(jnp.asarray(xt)))
    ref = tr.feature_model()
    ref.fit_gp(tr.t64(x), tr.t64(y))
    mu_r, sd_r = (a.numpy() for a in ref.mean_std(tr.t64(xt)))
    res = ranks[world]
    assert int(replicated(res, "fit_n")) == 256 == F.n
    for want_mu, want_sd in ((mu_j, sd_j), (mu_r, sd_r)):
        assert np.max(np.abs(replicated(res, "fit_mu") - want_mu)) <= FIT_ATOL
        assert np.max(np.abs(replicated(res, "fit_sd") - want_sd)) <= FIT_ATOL
