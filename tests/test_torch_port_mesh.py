"""Port parity: parallel/mesh.py and the sharded matrix-free products
(`make_lazy_matvec_sharded`, lazy_kernel's `make_*_sharded`) on gloo ranks
against the JAX package on a mesh of the conftest's virtual CPU devices.

The ranks run once for the module (tests/torch_ranks.py: spawned, float64,
worlds 2 and 4); the JAX side runs here on a `Mesh` of the first 2 or 4
devices, x64, traced under `jax.jit` where it is a function. Tolerances, in
float64: the sharded Gram and the products 1e-12 (against JAX and against
the port's single-device products), the distributed evidence's value and
gradient and the restart farm 1e-10 relative. Results that the port
returns replicated are bit for bit equal on every rank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from stpy_tpu.kernels import KernelFunction
from stpy_tpu.ops import pallas_gram_matvec as jgm
from stpy_tpu.parallel import lazy_kernel as jlk
from stpy_tpu.parallel import mesh as jmesh

import torch_ranks as tr
from torch_threads import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
PRODUCT_ATOL = 1e-12
EVIDENCE_RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Started before the module's first test; the JAX side runs while the
    ranks do, and the first read of a world joins them."""
    ranks = tr.Ranks("mesh_cases", WORLDS,
                     tmp_path_factory.mktemp("mesh_ranks"))
    yield ranks
    ranks.close()


def jax_mesh(p, shape=None):
    return Mesh(np.asarray(jax.devices()[:p]).reshape(shape or (1, p)),
                ("dp", "tp"))


def jax_kernel(case):
    se = lambda g: KernelFunction(kernel_name="squared_exponential",
                                  gamma=g, d=2)
    mat = lambda g: KernelFunction(kernel_name="matern", gamma=g, nu=1.5,
                                   d=2)
    return {"atom": lambda: se(0.5), "sum": lambda: se(0.5) + mat(0.8),
            "product": lambda: se(0.5) * mat(0.8),
            "laplace": lambda: KernelFunction(kernel_name="laplace",
                                              gamma=0.8, d=2)}[case]()


def replicated(results, key):
    """The rank-0 value of a replicated result, after checking that every
    rank holds the same bits."""
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


def close(got, want, atol):
    assert np.max(np.abs(np.asarray(got) - np.asarray(want))) <= atol


@pytest.mark.parametrize("world", WORLDS)
def test_shard_rows_and_replicate_hold_the_rank_blocks(ranks, world):
    x = tr.gram_points()
    nl = x.shape[0] // world
    for r, res in enumerate(ranks[world]):
        np.testing.assert_array_equal(res["shard_local"],
                                      x[r * nl:(r + 1) * nl])
        np.testing.assert_array_equal(res["shard_full"], x)
        np.testing.assert_array_equal(res["replicate_local"], x)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_gram_matches_jax(ranks, world):
    x = jnp.asarray(tr.gram_points())
    k = KernelFunction(kernel_name="squared_exponential", gamma=0.7, d=3)
    mesh = jax_mesh(world)
    want = jax.jit(lambda xs: jmesh.sharded_gram(
        lambda a, b: k.eval_params(k.params_dict, a, b), xs, mesh, "tp"))(
        jmesh.shard_rows(x, mesh, "tp"))
    got = replicated(ranks[world], "gram")
    close(got, want, PRODUCT_ATOL)
    assert tuple(ranks[world][0]["gram_local_rows"]) == (64 // world, 64)


def jax_nll(world, x, y, pd, s):
    mesh = jax_mesh(world)
    k = KernelFunction(kernel_name="squared_exponential", gamma=0.5,
                       d=x.shape[1])
    nll = jmesh.distributed_evidence(k, mesh, "tp")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("tp", None)))
    ys = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("tp", None)))
    return jax.jit(lambda pd, s: nll(pd, s, xs, ys)), k


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_evidence_value_matches_jax_and_the_exact_one(ranks,
                                                                   world):
    from stpy_tpu_torch.models import GaussianProcess

    x, y = tr.evidence_data()
    f, k = jax_nll(world, x, y, None, 0.1)
    want = float(f(k.params_dict, 0.1))
    got = float(replicated(ranks[world], "evidence"))
    assert abs(got - want) <= EVIDENCE_RTOL * abs(want)
    gp = GaussianProcess(kernel=tr.se(0.5, 2), s=0.1)
    gp.x, gp.y = tr.t64(x), tr.t64(y)
    exact = float(gp.log_marginal_params(gp.kernel_object, {}, 0.1))
    assert abs(got - exact) <= EVIDENCE_RTOL * abs(exact)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_evidence_gradient_matches_jax_grad(ranks, world):
    """The value and its gradient in γ and s equal jax.grad's of the JAX
    mesh evidence and the port's single-device autograd: a rank's rows
    carry only its part of ∂L/∂γ, and the gather's cotangent is not
    summed p times."""
    from stpy_tpu_torch.models import GaussianProcess

    x, y = tr.gradient_data()
    f, _ = jax_nll(world, x, y, None, 0.1)
    val, (gg, gs) = jax.value_and_grad(
        lambda g, s: f({"0": {"gamma": g}}, s), argnums=(0, 1))(
        jnp.asarray(0.5), jnp.asarray(0.1))
    got = replicated(ranks[world], "evidence_grad")
    want = np.asarray([float(val), float(gg), float(gs)])
    assert np.all(np.abs(got - want) <= EVIDENCE_RTOL * np.abs(want))
    gp = GaussianProcess(kernel=tr.se(0.5, 1), s=0.1)
    gp.x, gp.y = tr.t64(x), tr.t64(y)
    g = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    s = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    v = gp.log_marginal_params(gp.kernel_object, {"0": {"gamma": g}}, s)
    single = np.asarray([v.item()] + [t.item() for t in
                                      torch.autograd.grad(v, (g, s))])
    assert np.all(np.abs(got - single) <= EVIDENCE_RTOL * np.abs(single))


@pytest.mark.parametrize("world", WORLDS)
def test_restart_farm_matches_jax_over_dp(ranks, world):
    x, y = (jnp.asarray(a) for a in tr.farm_data())

    def nll(gamma):
        A = jnp.exp(-0.5 * (x - x.T) ** 2 / gamma ** 2) + 0.01 * jnp.eye(16)
        L = jnp.linalg.cholesky(A)
        alpha = jax.scipy.linalg.cho_solve((L, True), y)
        return 0.5 * (y.T @ alpha)[0, 0] + jnp.sum(jnp.log(jnp.diagonal(L)))

    mesh = jax_mesh(world, (world, 1))
    farm = jmesh.restart_farm(jax.value_and_grad(nll), 8, mesh, "dp")
    val, grad = jax.jit(farm)((jnp.asarray(tr.FARM_GAMMAS),))
    res = ranks[world]
    for key, want in (("farm_value", val), ("farm_grad", grad)):
        got = replicated(res, key)
        assert np.all(np.abs(got - np.asarray(want))
                      <= EVIDENCE_RTOL * np.abs(np.asarray(want))), key
    sq = jax.jit(jmesh.restart_farm(lambda th: jnp.sum(th ** 2), 8, mesh,
                                    "dp"))
    batch = jnp.arange(8.0)[:, None] * jnp.ones((8, 4))
    np.testing.assert_allclose(replicated(res, "farm_sq"),
                               np.asarray(sq((batch,))), rtol=0, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_lazy_matvec_sharded_matches_jax_and_one_device(ranks, world):
    from stpy_tpu_torch.ops.gram_matvec import make_lazy_matvec

    x, _, _, V = tr.lazy_data()
    mesh = jax_mesh(world)
    for fam in ("se", "matern"):
        want = jax.jit(jgm.make_lazy_matvec_sharded(
            jnp.asarray(x), mesh, "tp", family=fam, gamma=0.6, kappa=1.3,
            nu=1.5, noise=0.1))(jnp.asarray(V[:, 0]))
        got = replicated(ranks[world], f"lazy_matvec_{fam}")
        close(got, want, PRODUCT_ATOL)
        one = make_lazy_matvec(tr.t64(x), family=fam, gamma=0.6, kappa=1.3,
                               nu=1.5, noise=0.1)(tr.t64(V[:, 0]))
        close(got, one.numpy(), PRODUCT_ATOL)


def jax_sum_operators(case, x, mesh):
    ko = jax_kernel(case)
    atoms = jlk.fast_atoms(ko)
    gk = [jlk.atom_params(ko, a) for a in atoms]
    gs, ks = [g for g, _ in gk], [k for _, k in gk]
    return (jax.jit(jlk.make_sum_matvec_sharded(x, mesh, "tp", atoms, gs,
                                                ks, noise=0.1)),
            jax.jit(jlk.make_sum_matmat_sharded(x, mesh, "tp", atoms, gs,
                                                ks, noise=0.1)))


@pytest.mark.parametrize("world", WORLDS)
def test_sum_products_sharded_match_jax_and_one_device(ranks, world):
    from stpy_tpu_torch.parallel import lazy_kernel as tlk

    x, _, _, V = tr.lazy_data()
    mesh = jax_mesh(world)
    for case in ("atom", "sum"):
        mv, mm = jax_sum_operators(case, jnp.asarray(x), mesh)
        got_v = replicated(ranks[world], f"sum_matvec_{case}")
        got_m = replicated(ranks[world], f"sum_matmat_{case}")
        close(got_v, mv(jnp.asarray(V[:, 0])), PRODUCT_ATOL)
        close(got_m, mm(jnp.asarray(V)), PRODUCT_ATOL)
        ko = tr.lazy_kernel(case)
        atoms = tlk.fast_atoms(ko)
        gk = [tlk.atom_params(ko, a) for a in atoms]
        args = (tr.t64(x), atoms, [g for g, _ in gk], [k for _, k in gk])
        close(got_v, tlk.make_sum_matvec(*args, noise=0.1)(
            tr.t64(V[:, 0])).numpy(), PRODUCT_ATOL)
        close(got_m, tlk.make_sum_matmat(*args, noise=0.1)(
            tr.t64(V)).numpy(), PRODUCT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_chunked_products_sharded_match_jax(ranks, world):
    """The general tier over the mesh on a product and on a Laplace kernel,
    chunk 5 (ragged against each rank's 32 or 16 rows)."""
    x, _, _, V = tr.lazy_data()
    mesh = jax_mesh(world)
    for case in ("product", "laplace"):
        ko = jax_kernel(case)
        mv = jax.jit(jlk.make_chunked_matvec_sharded(
            ko, jnp.asarray(x), mesh, "tp", noise=0.1, chunk=5))
        mm = jax.jit(jlk.make_chunked_matmat_sharded(
            ko, jnp.asarray(x), mesh, "tp", noise=0.1, chunk=5))
        close(replicated(ranks[world], f"chunked_matvec_{case}"),
              mv(jnp.asarray(V[:, 0])), PRODUCT_ATOL)
        close(replicated(ranks[world], f"chunked_matmat_{case}"),
              mm(jnp.asarray(V)), PRODUCT_ATOL)


def test_make_mesh_without_a_group_starts_one_rank_gloo():
    """No process group and device="cpu": `make_mesh` starts a one-rank
    gloo group on a HashStore (no port), and the mesh tiers run on it: the
    one-rank lazy mesh tier is bit for bit the single-device lazy tier
    without a preconditioner."""
    import torch.distributed as dist

    from stpy_tpu_torch.parallel import IterativeGP, make_mesh, sharded_gram

    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert tuple(mesh.shape) == (1, 1)
        x, y, xt, _ = tr.lazy_data()
        k = tr.se(0.7, 2)
        K = sharded_gram(lambda a, b: k.eval_params(k.params_dict, a, b),
                         tr.t64(x), mesh)
        np.testing.assert_array_equal(tr.np_(K), k.eval_params(
            k.params_dict, tr.t64(x), tr.t64(x)).numpy())
        outs = []
        for m in (mesh, None):
            gp = IterativeGP(tr.lazy_kernel("sum"), s=0.1, mesh=m, lazy=True,
                             tol=1e-10, precond_rank=0)
            gp.fit_gp(x, y)
            outs.append(gp.mean(xt).numpy())
        np.testing.assert_array_equal(outs[0], outs[1])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
