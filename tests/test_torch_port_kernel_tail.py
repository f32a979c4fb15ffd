"""Port parity: the kernel tail of stpy_tpu_torch against stpy_tpu on the CPU.

Every `kernel_name` of the JAX `KernelFunction` table that the exact-GP
slice did not port (general-ν Matérn, modified Matérn, the full-covariance
kernels, gibbs, linear, polynomial, tanh, step, wiener, angsim, spectral,
the maps), `kernel_function=` custom callables and `groups=` for the
additive families, each through `cross`, `gram`, `diag`, `kernel` and the
`+`/`*` algebra. The same numpy inputs go to both packages, JAX in x64 and
the port in float64: entries agree within 1e-12 of max|K|; the port in
float32 within 1e-5. `bessel_kv` and the general-ν Matérn agree with the
JAX package's within 1e-13 and with scipy within its own bars
(tests/test_kernels.py:302-340); the kernel derivatives within 1e-10.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.kernels import functions as JF
from stpy_tpu.utils import groups as jax_groups
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.utils import groups as port_groups

from torch_threads import one_torch_thread  # noqa: F401

RTOL, F32_RTOL, DERIV_RTOL, BESSEL_RTOL = 1e-12, 1e-5, 1e-10, 1e-13
D = 3
COV = np.array([[1.2, 0.3, -0.1], [0.0, 0.9, 0.4], [0.2, -0.3, 1.1]])
FREQ = np.random.default_rng(5).normal(size=(6, D))


def _gibbs_jax(x):
    return 0.5 + 0.2 * jnp.sum(x * x, axis=1)


def _gibbs_torch(x):
    return 0.5 + 0.2 * torch.sum(x * x, dim=1)


def _gibbs_custom_jax(x, y):
    return 0.4 + 0.1 * (jnp.sum(x, 1)[:, None] + jnp.sum(y, 1)[None, :]) ** 2


def _gibbs_custom_torch(x, y):
    return 0.4 + 0.1 * (torch.sum(x, 1)[:, None] + torch.sum(y, 1)[None, :]) ** 2


class _Map:
    """A feature map with a `.map` method, as embeddings' random maps."""

    def __init__(self, lib):
        self.lib = lib

    def map(self, x):
        return self.lib.concatenate([self.lib.sin(2.0 * x), x ** 2], axis=1) \
            if self.lib is jnp else torch.cat([torch.sin(2.0 * x), x ** 2], 1)


def _custom_jax(p, a, b):
    return p["kappa"] * jnp.exp(-p["rho"] * JF.sq_dist(a, b)) + 0.1 * (a @ b.T)


def _custom_torch(p, a, b):
    return p["kappa"] * torch.exp(-p["rho"] * F.sq_dist(a, b)) + 0.1 * (a @ b.T)


# name: (shared kwargs, jax-only kwargs, port-only kwargs)
CASES = {
    "matern-nu1.2": (dict(kernel_name="matern", nu=1.2, gamma=0.7), {}, {}),
    "ard_matern-nu2.2": (dict(kernel_name="ard_matern", nu=2.2,
                              ard_gamma=[0.6, 0.9, 1.3]), {}, {}),
    **{f"modified_matern-{k}": (dict(kernel_name="modified_matern", nu=k,
                                     gamma=0.8, kappa=1.3), {}, {})
       for k in (1, 2, 3, 4)},
    "full_covariance_se": (dict(kernel_name="full_covariance_se", cov=COV),
                           {}, {}),
    "full_covariance_matern": (dict(kernel_name="full_covariance_matern",
                                    cov=COV, nu=1.7, kappa=0.8), {}, {}),
    "gibbs": (dict(kernel_name="gibbs"), dict(gamma_fun=_gibbs_jax),
              dict(gamma_fun=_gibbs_torch)),
    "gibbs_custom": (dict(kernel_name="gibbs_custom"),
                     dict(gamma_fun=_gibbs_custom_jax),
                     dict(gamma_fun=_gibbs_custom_torch)),
    "linear": (dict(kernel_name="linear", kappa=1.5, offset=0.3), {}, {}),
    "polynomial": (dict(kernel_name="polynomial", power=3, kappa=0.7), {}, {}),
    "tanh": (dict(kernel_name="tanh"), {}, {}),
    "step": (dict(kernel_name="step", kappa=0.6), {}, {}),
    "wiener": (dict(kernel_name="wiener"), {}, {}),
    "angsim": (dict(kernel_name="angsim", kappa=1.1), {}, {}),
    "spectral": (dict(kernel_name="spectral", freq=FREQ), {}, {}),
    "custom_map": (dict(kernel_name="custom_map"), dict(map=_Map(jnp).map),
                   dict(map=_Map(torch).map)),
    "random_map": (dict(kernel_name="random_map"), dict(map=_Map(jnp)),
                   dict(map=_Map(torch))),
    "ard-groups": (dict(kernel_name="ard", groups=[[0], [1, 2]],
                        ard_gamma=[0.5, 0.8, 1.1], kappa=1.4), {}, {}),
    "polynomial-groups": (dict(kernel_name="polynomial", groups=[[0, 2], [1]],
                               power=2), {}, {}),
    "se_per_group": (dict(kernel_name="squared_exponential_per_group",
                          groups=[[0, 2], [1]], gamma=0.6, kappa=0.9), {}, {}),
    "ard_per_group": (dict(kernel_name="ard_per_group", groups=[[0, 1], [2]],
                           params={"ard_per_group": [0.4, 0.7, 1.2]}), {}, {}),
    "custom": (dict(params={"rho": 0.8}, kappa=1.2),
               dict(kernel_function=_custom_jax),
               dict(kernel_function=_custom_torch)),
}


def kernels(case, dtype=torch.float64, d=D):
    shared, jax_kw, port_kw = CASES[case]
    jk = JaxKernel(d=d, **shared, **jax_kw)
    tk = TorchKernel(d=d, **shared, **port_kw, device="cpu", dtype=dtype)
    return jk, tk


def points(n, m, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, d)), rng.uniform(-1, 1, (m, d))


def rel(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def unbent(case, K):
    """angsim's (2/π)·asin(c) has an unbounded derivative at c = ±1, which
    K(x, x) reaches: one ulp of c there moves K by ~1e-8. Its entries are
    compared as c = sin(πK/(2κ)), the well-conditioned cosine."""
    if case != "angsim":
        return K
    K = K.detach().double().numpy() if isinstance(K, torch.Tensor) \
        else np.asarray(K, np.float64)
    return np.sin(0.5 * np.pi * K / CASES[case][0]["kappa"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_atom_matches_jax(case):
    a, b = points(13, 9)
    jk, tk = kernels(case)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    # the JAX `kernel` and `kernel_diag` are `cross`ᵀ and `diag` reshaped
    want = np.asarray(jk.cross(ja, jb))
    want_diag = np.asarray(jk.diag(ja))
    assert rel(tk.cross(a, b), want) <= RTOL
    assert rel(unbent(case, tk.gram(a)), unbent(case, jk.gram(ja))) <= RTOL
    assert rel(tk.kernel(a, b), want.T) <= RTOL
    assert rel(unbent(case, tk.diag(a)), unbent(case, want_diag)) <= RTOL
    assert rel(unbent(case, tk.kernel_diag(a, b)),
               unbent(case, want_diag.reshape(-1, 1))) <= RTOL
    t32 = kernels(case, dtype=torch.float32)[1]
    got32 = t32.cross(a, b)
    assert got32.dtype == torch.float32
    assert rel(got32, want) <= F32_RTOL


@pytest.mark.parametrize("first,second,op", [
    ("polynomial", "matern-nu1.2", "+"),
    ("linear", "ard-groups", "*"),
    ("custom", "spectral", "+"),
    ("se_per_group", "gibbs", "*"),
])
def test_composites_match_jax(first, second, op):
    a, b = points(11, 7, seed=1)
    (j1, t1), (j2, t2) = kernels(first), kernels(second)
    jk, tk = (j1 + j2, t1 + t2) if op == "+" else (j1 * j2, t1 * t2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert rel(tk.cross(a, b), jk.cross(ja, jb)) <= RTOL
    assert rel(tk.diag(a), jk.diag(ja)) <= RTOL
    assert tk.kernel_items == jk.kernel_items and tk.operations == jk.operations


@pytest.mark.parametrize("nu", [0.3, 0.7, 1.2, 2.2, 3.3])
def test_bessel_kv_matches_jax_and_scipy(nu):
    from scipy.special import kv as scipy_kv

    xs = np.logspace(-3, 1.4, 30)
    got = F.bessel_kv(nu, torch.as_tensor(xs)).numpy()
    assert rel(got, JF.bessel_kv(nu, jnp.asarray(xs))) <= BESSEL_RTOL
    ref = scipy_kv(nu, xs)
    assert np.max(np.abs(got - ref) / np.abs(ref)) < 1e-10


@pytest.mark.parametrize("nu", [0.8, 1.2, 3.3])
def test_general_nu_matern_matches_jax_and_scipy(nu):
    from scipy.special import kv as scipy_kv

    x, y = points(20, 15, seed=2)
    gamma = 0.9
    tk = TorchKernel(kernel_name="matern", gamma=gamma, nu=nu, d=D,
                     device="cpu", dtype=torch.float64)
    jk = JaxKernel(kernel_name="matern", gamma=gamma, nu=nu, d=D)
    K = tk.cross(x, y).numpy()
    assert rel(K, jk.cross(jnp.asarray(x), jnp.asarray(y))) <= BESSEL_RTOL
    r = np.maximum(np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1)) / gamma,
                   1e-10)
    arg = np.sqrt(2 * nu) * r
    ref = (2 ** (1 - nu) / math.gamma(nu)) * arg ** nu * scipy_kv(nu, arg)
    assert np.abs(K - ref).max() < 1e-9
    # the diagonal is exactly κ, as the JAX limit makes it
    assert torch.equal(torch.diagonal(tk.gram(x)), torch.ones(20,
                                                              dtype=torch.float64))


@pytest.mark.parametrize("case", ["ard-groups", "full_covariance_se"])
def test_derivatives_match_jax(case):
    fixed, x = points(3, 2, seed=3)
    jk, tk = kernels(case)
    jf, jx = jnp.asarray(fixed), jnp.asarray(x)
    assert rel(tk.derivative_1(fixed, x), jk.derivative_1(jf, jx)) <= DERIV_RTOL
    assert rel(tk.derivative_2(fixed, x), jk.derivative_2(jf, jx)) <= DERIV_RTOL


def test_se_closed_form_derivatives_match_jax():
    fixed, x = points(5, 4, seed=4)
    jk = JaxKernel(kernel_name="squared_exponential", gamma=0.6, d=D)
    tk = TorchKernel(kernel_name="squared_exponential", gamma=0.6, d=D,
                     device="cpu", dtype=torch.float64)
    jf, jx = jnp.asarray(fixed), jnp.asarray(x)
    assert rel(tk.get_1_der(fixed, x), jk.get_1_der(jf, jx)) <= DERIV_RTOL
    assert rel(tk.get_2_der(fixed, x), jk.get_2_der(jf, jx)) <= DERIV_RTOL


def test_linear_embedding_and_basis_size():
    x = points(6, 1)[0]
    jk, tk = kernels("linear")
    assert np.array_equal(tk.embed(x).numpy(), np.asarray(jk.embed(x)))
    assert tk.get_basis_size() == jk.get_basis_size() == D
    _, other = kernels("polynomial")
    with pytest.raises(AttributeError, match="finite dimensional"):
        other.embed(x)


def test_groups_helpers_match_jax():
    for d in range(0, 6):
        assert port_groups.generate_groups(d) == jax_groups.generate_groups(d)
        assert port_groups.all_pairs(d) == jax_groups.all_pairs(d)
        assert port_groups.singletons(d) == jax_groups.singletons(d)
    assert len(port_groups.generate_groups(4)) == 15     # Bell(4)


def test_no_pair_broadcast_in_the_per_feature_kernels(monkeypatch):
    """step, wiener and modified_matern accumulate feature by feature and
    bessel_kv node by node: no intermediate grows with n·m·d or n·m·384."""
    seen = []
    real_exp = torch.exp

    def spy(t, *args, **kw):
        seen.append(t.numel())
        return real_exp(t, *args, **kw)

    monkeypatch.setattr(torch, "exp", spy)
    a, b = points(30, 20, seed=6)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    F.modified_matern({"gamma": torch.tensor(0.8)}, ta, tb, nu=2)
    F.matern({"gamma": torch.tensor(0.8)}, ta, tb, nu=1.3)
    assert seen and max(seen) <= 30 * 20
    assert F.step({}, ta, tb).shape == F.wiener({}, ta, tb).shape == (30, 20)
