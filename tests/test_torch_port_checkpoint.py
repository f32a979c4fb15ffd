"""Port parity: stpy_tpu_torch/utils/checkpoint.py against
stpy_tpu/utils/checkpoint.py on the CPU, JAX in x64 and torch in float64.

A tree written by either package's `save_pytree` loads in the other's
`load_pytree` with its values equal (the npz layout is shared); a fitted
port `GaussianProcess` round-trips `save_model` / `load_model` with
`mean_std` unchanged bit for bit, and a JAX-saved one loads into a port
GP and serves the JAX posterior within 1e-10; `OptimalPositiveBasis`
round-trips `save_embedding` / `load_embedding` in the port, and a basis
saved by the JAX package loads in the port and embeds as the JAX one does
after its own load, within 1e-10.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import nystrom as jn
from stpy_tpu.kernels import KernelFunction as JKernel
from stpy_tpu.models import GaussianProcess as JGP
from stpy_tpu.utils import checkpoint as jc
from stpy_tpu_torch import KernelFunction as TKernel
from stpy_tpu_torch.embeddings import nystrom as tn
from stpy_tpu_torch.models import GaussianProcess as TGP
from stpy_tpu_torch.utils import checkpoint as tc

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def tree(rng):
    return {"w": rng.standard_normal((3, 4)),
            "layers": [{"b": rng.standard_normal(5)},
                       {"b": rng.standard_normal(2), "s": np.float64(0.5)}],
            "pair": (np.arange(3), rng.standard_normal((2, 2)))}


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            assert_same(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


def test_trees_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(0)
    t = tree(rng)
    jc.save_pytree(tmp_path / "from_jax.npz", t)
    tc.save_pytree(tmp_path / "from_port.npz",
                   {"w": torch.as_tensor(t["w"]), "layers": t["layers"],
                    "pair": (torch.as_tensor(t["pair"][0]), t["pair"][1])})
    for name in ("from_jax.npz", "from_port.npz"):
        got = tc.load_pytree(tmp_path / name, device="cpu")
        want = jc.load_pytree(tmp_path / name)
        assert_same(got, want)
        assert got["layers"]["1"]["s"].dtype == torch.float64
        assert isinstance(got["pair"]["0"], torch.Tensor)
    # the JAX package's files carry the same keys as the port's
    with np.load(tmp_path / "from_jax.npz") as a, \
            np.load(tmp_path / "from_port.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_load_into_like_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    like = {"b": np.zeros(2), "a": [np.zeros(3), np.zeros((1, 2))]}
    jc.save_pytree(tmp_path / "t", {"b": rng.standard_normal(2),
                                    "a": [rng.standard_normal(3),
                                          rng.standard_normal((1, 2))]})
    got = tc.load_pytree(tmp_path / "t", like=like, device="cpu")
    want = jc.load_pytree(tmp_path / "t", like=like)
    assert list(got) == sorted(like) and isinstance(got["a"], list)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def fitted_gps():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((40, 1))
    j = JGP(gamma=0.4, s=0.1, d=2)
    t = TGP(gamma=0.4, s=0.1, d=2, **F64)
    j.fit_gp(jnp.asarray(x), jnp.asarray(y))
    t.fit_gp(x, y)
    return j, t


def test_gp_round_trips_save_model_load_model(tmp_path):
    j, t = fitted_gps()
    xt = np.random.default_rng(3).uniform(-1, 1, (25, 2))
    mu, sd = t.mean_std(xt)
    tc.save_model(tmp_path / "gp.npz", t)
    fresh = TGP(gamma=1.3, s=0.1, d=2, **F64)
    tc.load_model(tmp_path / "gp.npz", fresh)
    assert fresh.fitted
    mu2, sd2 = fresh.mean_std(xt)
    assert torch.equal(mu, mu2) and torch.equal(sd, sd2)
    # a GP saved by the JAX package serves the JAX posterior in the port
    jc.save_model(tmp_path / "jax_gp.npz", j)
    fresh = TGP(gamma=1.3, s=0.1, d=2, **F64)
    tc.load_model(tmp_path / "jax_gp.npz", fresh)
    for a, b in zip(fresh.mean_std(xt), j.mean_std(jnp.asarray(xt))):
        assert rel(a, b) < RTOL


KW = dict(samples=40, B=4.0, s=1e-3)


def port_basis(seed):
    tk = TKernel(kernel_name="squared_exponential", gamma=0.3, d=1, **F64)
    return tn.OptimalPositiveBasis(
        1, 4, kernel_object=tk, **KW, **F64,
        generator=torch.Generator().manual_seed(seed))


def test_optimal_positive_basis_round_trips(tmp_path):
    T = port_basis(0)
    x = np.linspace(-1, 1, 33)[:, None]
    before = T.embed(x)
    T.save_embedding(tmp_path / "port_basis")
    T2 = port_basis(1)                      # another basis ...
    assert rel(T2.embed(x), before) > 1e-3
    T2.load_embedding(tmp_path / "port_basis")   # ... replaced by the saved
    assert rel(T2.embed(x), before) < 1e-12
    # a JAX-saved basis embeds in the port as it does in the JAX package
    jk = JKernel(kernel_name="squared_exponential", gamma=0.3, d=1)
    J = jn.OptimalPositiveBasis(1, 4, kernel_object=jk, **KW)
    J.save_embedding(tmp_path / "jax_basis")
    J.load_embedding(tmp_path / "jax_basis")
    T2.load_embedding(tmp_path / "jax_basis")
    assert rel(T2.embed(x), J.embed(jnp.asarray(x))) < RTOL
    # and a port-saved one in the JAX package
    J.load_embedding(tmp_path / "port_basis")
    assert rel(before, J.embed(jnp.asarray(x))) < RTOL
