"""Port parity: the group search and the manifold fits of `GaussianProcess`
(`optimize_params(type="groups" | "covariance" | "rots")`,
`Estimator._optimize_discrete`, opt/manifold.py) against stpy_tpu on the
CPU, JAX in x64 and the port in float64 on the same numpy data.

* groups: every partition of d = 3 and d = 4 coordinates (Bell(3) = 5,
  Bell(4) = 15), scored by the evidence in the JAX package's order with its
  strict <: the same partition, and the evidence there within 1e-10.
* covariance / rots: one restart from the JAX package's own draw
  (regenerated by `jax.random.split` / `normal` and fed to
  `manifold._normal`). After a fixed small number of iterations the fitted
  `cov` agrees within 1e-8 and the evidence within 1e-10; run to the end
  (25 iterations), the evidence within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_kernel_params
from stpy_tpu_torch.opt import manifold

from torch_threads import one_torch_thread  # noqa: F401

EVIDENCE_RTOL, COV_RTOL, END_RTOL = 1e-10, 1e-8, 1e-6
S = 0.1


def data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    # additive in {0, 1} and {2, ...}: a partition with a clear optimum
    y = (np.sin(3 * x[:, 0] * x[:, 1]) + np.cos(2 * x[:, 2:].sum(1)))[:, None]
    return x, y + 0.05 * rng.standard_normal((n, 1))


def gp_pair(d, **kernel_kw):
    jg = JaxGP(kernel=JaxKernel(d=d, **kernel_kw), s=S)
    tg = TorchGP(kernel=TorchKernel(d=d, **kernel_kw, device="cpu",
                                    dtype=torch.float64), s=S)
    return jg, tg


def evidence(gp):
    value = gp.log_marginal_params(gp.kernel_object, {}, gp.s)
    return float(value.detach()) if isinstance(value, torch.Tensor) \
        else float(value)


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("d", [3, 4])
def test_group_search_matches_jax(d):
    x, y = data(48, d)
    kw = dict(kernel_name="ard", groups=[[i] for i in range(d)],
              ard_gamma=[0.6] * d)
    jg, tg = gp_pair(d, **kw)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    jg.optimize_params(type="groups")
    tg.optimize_params(type="groups")
    jgroups = jg.kernel_object._atoms[0].static["groups"]
    tgroups = tg.kernel_object._atoms[0].static["groups"]
    assert tgroups == jgroups and len(tgroups) < d
    assert rel(evidence(tg), evidence(jg)) <= EVIDENCE_RTOL
    # the port serves the refit on the chosen groups. The JAX GP serves
    # from jitted closures traced before the search, with the old groups
    # (ROADMAP Queue 3), so the reference is a fresh JAX GP on them
    fresh = JaxGP(kernel=JaxKernel(d=d, **{**kw, "groups": jgroups}), s=S)
    fresh.fit_gp(jnp.asarray(x), jnp.asarray(y))
    mu_j, _ = fresh.mean_std(jnp.asarray(x[:8]))
    mu_t, _ = tg.mean_std(x[:8])
    assert np.max(np.abs(mu_t.numpy() - np.asarray(mu_j))) <= 1e-8


def test_discrete_search_over_an_explicit_list():
    """optimizer="discrete" through optimize_params_general, on the
    polynomial's additive groups: each listed structure scored, the first
    least one kept."""
    x, y = data(40, 3, seed=1)
    kw = dict(kernel_name="polynomial", groups=[[0, 1, 2]], power=2)
    jg, tg = gp_pair(3, **kw)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    configs = [[[0, 1, 2]], [[0, 1], [2]], [[0], [1], [2]], [[0, 2], [1]]]
    spec = {"0": {"groups": (None, configs, None)}}
    jg.optimize_params_general(params=spec, optimizer="discrete")
    tg.optimize_params_general(params=spec, optimizer="discrete")
    assert tg.kernel_object._atoms[0].static["groups"] == \
        jg.kernel_object._atoms[0].static["groups"]
    assert rel(evidence(tg), evidence(jg)) <= EVIDENCE_RTOL


def feed_jax_draws(monkeypatch, key, restarts, shape):
    """The normals the JAX manifold fits draw, one a restart, fed in order
    to the port's `manifold._normal`."""
    draws = [np.asarray(jax.random.normal(k, shape, jnp.float64))
             for k in jax.random.split(key, restarts)]

    def take(_generator, shp, device):
        out = draws.pop(0)
        assert tuple(shp) == out.shape
        return torch.as_tensor(np.array(out), device=device)

    monkeypatch.setattr(manifold, "_normal", take)


COV0 = [[1.0, 0.2, 0.0], [0.0, 0.8, 0.1], [0.1, 0.0, 1.2]]


@pytest.mark.parametrize("kind,shape,iters", [
    ("covariance", (9,), 4), ("rots", (3, 3), 5)])
def test_manifold_fit_matches_jax_from_the_same_start(monkeypatch, kind,
                                                      shape, iters):
    x, y = data(40, 3, seed=2)
    for maxiter, rtol in ((iters, COV_RTOL), (25, END_RTOL)):
        jg, tg = gp_pair(3, kernel_name="full_covariance_se", cov=COV0)
        jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
        tg.fit_gp(x, y)
        key = jax.random.PRNGKey(3)
        feed_jax_draws(monkeypatch, key, 1, shape)
        jg.optimize_params(type=kind, restarts=1, maxiter=maxiter, key=key)
        tg.optimize_params(type=kind, restarts=1, maxiter=maxiter)
        jc = np.asarray(jg.kernel_object.params_dict["0"]["cov"])
        tc = tg.kernel_object.params_dict["0"]["cov"].numpy()
        if maxiter == iters:
            assert np.max(np.abs(tc - jc)) / np.max(np.abs(jc)) <= rtol
            assert rel(evidence(tg), evidence(jg)) <= EVIDENCE_RTOL
        else:
            assert rel(evidence(tg), evidence(jg)) <= rtol
            # the JAX fit's cov carried across: the same evidence
            load_kernel_params(tg.kernel_object, {"0": {"cov": jc}})
            assert rel(evidence(tg), evidence(jg)) <= EVIDENCE_RTOL
        if kind == "rots":
            assert np.allclose(tc.T @ tc, np.eye(3), atol=1e-12)
        assert tg.fitted


def test_stiefel_tangent_projection_and_retraction():
    rng = np.random.default_rng(4)
    X = manifold._qr_retract(torch.as_tensor(rng.standard_normal((5, 3))))
    assert torch.allclose(X.T @ X, torch.eye(3, dtype=X.dtype), atol=1e-14)
    G = torch.as_tensor(rng.standard_normal((5, 3)))
    P = manifold.stiefel_project_tangent(X, G)
    sym = X.T @ P
    assert torch.allclose(sym + sym.T, torch.zeros(3, 3, dtype=X.dtype),
                          atol=1e-14)


def test_manifold_fits_default_to_the_card_and_never_the_cpu():
    """With no `device` and no CUDA, both manifold fits raise instead of
    quietly running on the CPU; on the CPU when asked they run."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")

    def fun(A):
        return (A * A).sum()

    with pytest.raises(RuntimeError, match="device='cpu'"):
        manifold.optimize_stiefel(fun, 3, 2, steps=1, restarts=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        manifold.optimize_psd(fun, 2, restarts=1, max_iter=1)
    g = torch.Generator().manual_seed(0)
    X, _ = manifold.optimize_stiefel(fun, 3, 2, steps=1, restarts=1,
                                     generator=g, device="cpu")
    A, _ = manifold.optimize_psd(fun, 2, restarts=1, max_iter=1,
                                 generator=g, device="cpu")
    assert X.device.type == A.device.type == "cpu"
