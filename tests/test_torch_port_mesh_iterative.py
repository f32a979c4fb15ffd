"""Port parity: the mesh tiers of `IterativeGP` (lazy, dense block-Jacobi,
double) on gloo ranks against the JAX package's mesh tiers and the port's
own single-device tiers.

The ranks run once for the module (tests/torch_ranks.py: spawned, float64,
worlds 2 and 4, n = 64 points, 16 test points); the JAX side runs here on
a `Mesh` of the first 4 virtual CPU devices at tol = 1e-10, as
tests/test_parallel.py:468-507, while the ranks run. Tolerances, in float64: against the JAX
mesh tiers 1e-8 relative for the mean (to its largest entry) and 1e-6 for
the std, entry by entry (the two packages' CG rounding differs, as in
tests/test_torch_port_iterative.py); against the port's single-device lazy
tier with no preconditioner (`precond_rank=0`, the mesh tier's own) 1e-12,
since every output row of a sharded product is the single-device row. The
JAX double tier is not run over a mesh (its test alone takes 600 s): the
port's mesh double tier is held to the port's single-device double tier,
which tests/test_torch_port_iterative*.py hold to JAX, and to dense
float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stpy_tpu.kernels import KernelFunction
from stpy_tpu.parallel import IterativeGP as JaxIterativeGP

import torch_ranks as tr
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
MEAN_RTOL, STD_RTOL = 1e-8, 1e-6
SAME_RTOL = 1e-12
DOUBLE_MEAN_RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test; the JAX side runs while the
    ranks do, and the first read of a world joins them."""
    ranks = tr.Ranks("iterative_cases", WORLDS,
                     tmp_path_factory.mktemp("iterative_ranks"))
    yield ranks
    ranks.close()


def jax_kernel(case):
    se = lambda g: KernelFunction(kernel_name="squared_exponential",
                                  gamma=g, d=2)
    mat = lambda g: KernelFunction(kernel_name="matern", gamma=g, nu=1.5,
                                   d=2)
    return {"atom": lambda: se(0.5), "sum": lambda: se(0.5) + mat(0.8),
            "product": lambda: se(0.5) * mat(0.8)}[case]()


def jax_tier(case, world, lazy):
    x, y, xt, _ = tr.lazy_data()
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(1, world),
                ("dp", "tp"))
    gp = JaxIterativeGP(jax_kernel(case), s=0.1, mesh=mesh, axis="tp",
                        lazy=lazy, tol=1e-10, chunk=16)
    gp.fit_gp(jnp.asarray(x), jnp.asarray(y))
    mu, sd = gp.mean_std(jnp.asarray(xt))
    return np.asarray(mu), np.asarray(sd)


def rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def replicated(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


@pytest.fixture(scope="module")
def jax_tiers(ranks):
    """The JAX mesh tiers on 4 devices, computed while the ranks run, for
    both worlds: the lazy tier of each case and the dense tier (its eager
    fit compiles ~200 programs, ~11 s on the CPU). No sharded product
    reduces across devices, so the world changes no lazy iterate beyond
    rounding, and a world's block-Jacobi changes the dense iterates, not
    the converged posterior at tol 1e-10."""
    out = {case: jax_tier(case, 4, lazy=True) for case in tr.LAZY_CASES}
    out["dense"] = jax_tier("sum", 4, lazy=False)
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", tr.LAZY_CASES)
def test_lazy_mesh_tier_matches_jax_mesh_tier(ranks, jax_tiers, case, world):
    """An atom and a sum (one fused pass per atom per rank) and a product
    (the row-chunked general tier, chunk 16) over the mesh."""
    mu_j, sd_j = jax_tiers[case]
    res = ranks[world]
    mu = replicated(res, f"lazy_{case}_mu")
    sd = replicated(res, f"lazy_{case}_sd")
    assert replicated(res, f"lazy_{case}_cg")[0] < 1e-8
    assert rel(mu, mu_j) <= MEAN_RTOL
    assert np.max(np.abs(sd - sd_j) / sd_j) <= STD_RTOL


@pytest.mark.parametrize("world", WORLDS)
def test_lazy_mesh_tier_is_the_one_device_tier_without_preconditioner(
        ranks, world):
    from stpy_tpu_torch.parallel import IterativeGP

    x, y, xt, _ = tr.lazy_data()
    for case in tr.LAZY_CASES:
        gp = IterativeGP(tr.lazy_kernel(case), s=0.1, lazy=True, tol=1e-10,
                         chunk=16, precond_rank=0)
        gp.fit_gp(x, y)
        mu, sd = (a.numpy() for a in gp.mean_std(xt))
        res = ranks[world]
        assert res[0][f"lazy_{case}_cg"][1] == gp.cg_iterations, case
        assert rel(res[0][f"lazy_{case}_mu"], mu) <= SAME_RTOL, case
        assert rel(res[0][f"lazy_{case}_sd"], sd) <= SAME_RTOL, case


@pytest.mark.parametrize("world", WORLDS)
def test_dense_mesh_tier_block_jacobi_matches_jax(ranks, jax_tiers, world):
    """The dense mesh tier: each rank's (n/p, n) Gram rows with σ² at its
    global offset, block-Jacobi from each rank's diagonal block, the block
    CG variance preconditioned the same way."""
    res = ranks[world]
    mu_j, sd_j = jax_tiers["dense"]
    assert replicated(res, "dense_cg")[0] < 1e-8
    assert rel(replicated(res, "dense_mu"), mu_j) <= MEAN_RTOL
    sd = replicated(res, "dense_sd")
    assert np.max(np.abs(sd - sd_j) / sd_j) <= STD_RTOL


def float64_posterior(case):
    x, y, xt, _ = tr.lazy_data()
    k = tr.lazy_kernel(case)
    K = k.eval_params(k.params_dict, tr.t64(x), tr.t64(x)).numpy()
    Ks = k.eval_params(k.params_dict, tr.t64(xt), tr.t64(x)).numpy()
    A = K + 0.01 * np.eye(len(x))
    mu = Ks @ np.linalg.solve(A, y)
    var = k.diag(tr.t64(xt)).numpy() - np.sum(Ks.T * np.linalg.solve(A, Ks.T),
                                              axis=0)
    return mu, np.sqrt(var)[:, None]


@pytest.mark.parametrize("world", WORLDS)
def test_double_mesh_tiers_match_one_device_double_and_float64(ranks, world):
    """precision="double" over the mesh, lazy and dense: the df residual
    and mean GEMVs row-sharded, the refinement contracting; the mean held
    to the port's single-device double tier and to dense float64, the std
    (CG-grade: var_refine is not used on a mesh) to dense float64."""
    from stpy_tpu_torch.parallel import IterativeGP

    x, y, xt, _ = tr.lazy_data()
    one = IterativeGP(tr.lazy_kernel("double"), s=0.1, lazy=True,
                      precision="double", tol=1e-8, df_chunk=32,
                      precond_rank=0)
    one.fit_gp(x, y)
    mu_one = one.mean(xt).numpy()
    mu64, sd64 = float64_posterior("double")
    res = ranks[world]
    for tag in ("lazy", "dense"):
        mu = replicated(res, f"double_{tag}_mu")
        sd = replicated(res, f"double_{tag}_sd")
        assert replicated(res, f"double_{tag}_res")[-1] < 1e-7, tag
        assert rel(mu, mu_one) <= DOUBLE_MEAN_RTOL, tag
        assert rel(mu, mu64) <= DOUBLE_MEAN_RTOL, tag
        assert np.max(np.abs(sd - sd64) / sd64) <= STD_RTOL, tag
