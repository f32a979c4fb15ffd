"""Port parity: the general double tier (kernels/df_plan.py) and the Laplace
L1 family of the double-float Gram, on the CPU.

Every atom outside the fused families is evaluated by its own torch
function in float64 and split into (hi, lo); general-ν Matérn is one of
them. Against the JAX package in x64 on the same numpy inputs:
hi + lo within 1e-13 of max|K| of `F.<atom>`, and within 1e-12 of the JAX
package's own double tier (its df interpreter, the bar of
tests/test_df_interp.py:307). A `GaussianProcess(precision="double")`
posterior with SE + linear, a polynomial and a general-ν Matérn matches
JAX's within 1e-7 (mean, and std at var_refine=1), the bars of
tests/test_df_interp.py:211-224 and tests/test_matern_gen_df.py:97-134 at
the f32 floor: the port returns the df mean and std as f32 (hi + lo
rounded once, up to 6e-8 of max|μ|), where the JAX package in x64 returns
float64.

Laplace: the port's double tier computes the single tier's L1 kernel
(`gram_df_plain`'s L1 family within 1e-13 of the JAX `F.laplace`), where
the JAX package's double tier computes an L2 Matérn-½
(tests/test_torch_port_gram_l1.py shows the gap). Its posterior is held
to the port's float64 model on the L1 Gram.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu.kernels import functions as JF
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.kernels import df_plan
from stpy_tpu_torch.ops.gram_df import gram_df, gram_df_plain, scale_coords
from stpy_tpu_torch.parallel.iterative import IterativeGP

from torch_threads import one_torch_thread  # noqa: F401

F64_RTOL, JAX_DF_RTOL, MEAN_RTOL, STD_RTOL = 1e-13, 1e-12, 1e-7, 1e-7
D = 2

ATOMS = {
    "polynomial": dict(kernel_name="polynomial", power=3, kappa=0.7),
    "linear": dict(kernel_name="linear", kappa=1.5, offset=0.3),
    "matern-nu1.2": dict(kernel_name="matern", nu=1.2, gamma=0.8),
    "ard_matern-nu2.2": dict(kernel_name="ard_matern", nu=2.2, kappa=1.7,
                             ard_gamma=[0.7, 1.1]),
    "ard-groups": dict(kernel_name="ard", groups=[[0], [1]],
                       ard_gamma=[0.5, 0.9]),
    "step": dict(kernel_name="step", kappa=0.6),
    "tanh": dict(kernel_name="tanh"),
}


def f32_exact(a):
    """Data every tier sees alike: f64 values that are f32 numbers."""
    return np.asarray(a, np.float32).astype(np.float64)


def points(n, m, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return (f32_exact(rng.uniform(-1, 1, (n, d))),
            f32_exact(rng.uniform(-1, 1, (m, d))))


def pair64(h, l):
    return (np.asarray(h, np.float32).astype(np.float64)
            + np.asarray(l, np.float32).astype(np.float64))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def port_df(tk, a, b):
    desc = df_plan.df_atom_desc(tk)
    return df_plan.df_gram_from_desc(tk, {}, torch.as_tensor(a),
                                     torch.as_tensor(b), desc)


@pytest.mark.parametrize("case", sorted(ATOMS))
def test_df_pair_is_the_float64_atom(case):
    a, b = points(23, 17)
    jk = JaxKernel(d=D, **ATOMS[case])
    tk = TorchKernel(d=D, **ATOMS[case], device="cpu")
    h, l = port_df(tk, a, b)
    assert h.dtype == l.dtype == torch.float32
    want = np.asarray(jk.cross(jnp.asarray(a), jnp.asarray(b)))
    assert rel(pair64(h, l), want) <= F64_RTOL
    # hi is the f32 rounding of the float64 entry
    assert np.array_equal(h.numpy(), want.astype(np.float32))
    fam = df_plan.df_atom_desc(tk)[0][1]
    assert fam == ("matern_gen" if "nu" in ATOMS[case] else "generic")


@pytest.mark.parametrize("case,bar", [
    # the generic tier: the df interpreter's bar (tests/test_df_interp.py:307)
    ("polynomial", JAX_DF_RTOL),
    # general ν: ops/matern_df.py's node-scanned df Bessel sits ~1e-8 from
    # float64 (its own bar, 5e-9 absolute, tests/test_matern_gen_df.py:41);
    # the port's pair is the float64 atom (test above)
    ("matern-nu1.2", 1e-8),
])
def test_df_pair_matches_the_jax_double_tier(case, bar):
    a, b = points(19, 11, seed=1)
    jk = JaxKernel(d=D, **ATOMS[case])
    tk = TorchKernel(d=D, **ATOMS[case], device="cpu")
    jh, jl = jax_df_plan.df_gram_from_desc(
        jk, jk.params_dict, jnp.asarray(a), jnp.asarray(b),
        jax_df_plan.df_atom_desc(jk))
    assert [d[1:] for d in df_plan.df_atom_desc(tk)] == \
        [d[1:] for d in jax_df_plan.df_atom_desc(jk)]
    assert rel(pair64(*port_df(tk, a, b)), pair64(jh, jl)) <= bar


def test_ard_general_nu_kappa_and_exact_diagonal():
    x = points(32, 1, seed=2, d=3)[0]
    kw = dict(kernel_name="ard_matern", nu=2.2, kappa=1.7,
              ard_gamma=[0.7, 1.1, 0.9], d=3)
    tk = TorchKernel(**kw, device="cpu")
    got = pair64(*port_df(tk, x, x))
    want = np.asarray(JF.ard_matern(
        {"ard_gamma": jnp.asarray([0.7, 1.1, 0.9]), "kappa": 1.7},
        jnp.asarray(x), jnp.asarray(x), nu=2.2))
    assert rel(got, want) <= F64_RTOL
    assert np.abs(np.diag(got) - 1.7).max() < 1e-12
    dh, dl = df_plan.df_diag_from_desc(tk, {}, torch.as_tensor(x),
                                       df_plan.df_atom_desc(tk), chunk=8)
    assert np.abs(pair64(dh, dl) - 1.7).max() < 1e-12


def test_generic_diag_of_a_polynomial_is_exact():
    x = points(700, 1, seed=3)[0]
    tk = TorchKernel(kernel_name="polynomial", power=3, d=D, device="cpu")
    dh, dl = df_plan.df_diag_from_desc(tk, {}, torch.as_tensor(x),
                                       df_plan.df_atom_desc(tk), chunk=512)
    ref = ((x * x).sum(1) + 1.0) ** 3
    assert np.abs(pair64(dh, dl) - ref).max() / np.abs(ref).max() < 1e-12


def _se_plus_linear(pkg):
    K = JaxKernel if pkg == "jax" else TorchKernel
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return (K(kernel_name="squared_exponential", gamma=0.7, d=D, **kw)
            + K(kernel_name="linear", d=D, **kw))


def _single(name):
    def make(pkg):
        K = JaxKernel if pkg == "jax" else TorchKernel
        kw = {} if pkg == "jax" else {"device": "cpu"}
        return K(d=D, **ATOMS[name], **kw)
    return make


GPS = {"se+linear": _se_plus_linear, "polynomial": _single("polynomial"),
       "matern-nu1.2": _single("matern-nu1.2")}


@pytest.fixture(scope="module")
def gp_data():
    rng = np.random.default_rng(4)
    x = f32_exact(rng.uniform(-1, 1, (64, D)))
    y = f32_exact(np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((64, 1)))
    return x, y, points(24, 1, seed=5)[0]


@pytest.mark.parametrize("case", sorted(GPS))
def test_double_tier_posterior_matches_jax(gp_data, case):
    x, y, xt = gp_data
    jg = JaxGP(kernel=GPS[case]("jax"), s=0.1, precision="double",
               var_refine=1)
    jm, js = jg.fit_predict(jnp.asarray(x, jnp.float32),
                            jnp.asarray(y, jnp.float32),
                            jnp.asarray(xt, jnp.float32))
    for var_refine in (0, 1):
        tg = TorchGP(kernel=GPS[case]("port"), s=0.1, precision="double",
                     var_refine=var_refine)
        assert tg._df_refine_steps_resolved == (
            3 if case == "polynomial" or case == "se+linear" else 1)
        tm, ts = tg.fit_predict(x, y, xt)
        # the mean does not depend on var_refine
        assert rel(tm.numpy(), jm) <= MEAN_RTOL
        if var_refine:
            assert rel(ts.numpy(), js) <= STD_RTOL


def test_laplace_l1_family_is_the_single_tier_kernel():
    a, b = points(31, 20, seed=6, d=3)
    gamma, kappa = 0.7, 1.3
    want = np.asarray(JF.laplace({"gamma": gamma, "kappa": kappa},
                                 jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    g2 = torch.tensor(gamma, dtype=torch.float64) ** 2
    plain = gram_df_plain(scale_coords(ta, g2), scale_coords(tb, g2), kappa,
                          "laplace")
    assert rel(pair64(*plain), want) <= F64_RTOL
    got = gram_df(ta, tb, torch.tensor(gamma, dtype=torch.float64), kappa,
                  family="laplace")
    assert all(torch.equal(p, q) for p, q in zip(got, plain))
    tk = TorchKernel(kernel_name="laplace", gamma=gamma, kappa=kappa, d=3,
                     device="cpu")
    assert df_plan.df_atom_desc(tk) == [(0, "laplace", 0.5, "gamma", None, "-")]
    assert rel(pair64(*port_df(tk, a, b)), want) <= F64_RTOL


@pytest.mark.parametrize("var_refine", [0, 1])
def test_laplace_double_tier_posterior_is_the_float64_l1_posterior(
        gp_data, var_refine):
    x, y, xt = gp_data
    kw = dict(kernel_name="laplace", gamma=0.9, d=D, device="cpu")
    f64 = TorchGP(kernel=TorchKernel(**kw, dtype=torch.float64), s=0.1)
    mu64, sd64 = f64.fit_predict(x, y, xt)
    gp = TorchGP(kernel=TorchKernel(**kw), s=0.1, precision="double",
                 var_refine=var_refine)
    mu, sd = gp.fit_predict(x, y, xt)
    assert rel(mu.numpy(), mu64.numpy()) <= MEAN_RTOL
    if var_refine:
        assert rel(sd.numpy(), sd64.numpy()) <= STD_RTOL


def test_matrix_free_double_tier_takes_a_generic_atom(gp_data):
    """IterativeGP(precision="double") reads the same plan: its df mean on
    SE + linear agrees with the dense float64 posterior."""
    x, y, xt = gp_data
    f64 = TorchGP(kernel=_se_plus_linear("port"), s=0.1)
    f64.kernel_object.dtype = torch.float64
    f64.dtype = torch.float64
    mu64, _ = f64.fit_predict(x, y, xt)
    gp = IterativeGP(_se_plus_linear("port"), s=0.1, precision="double",
                     var_refine=0, tol=1e-10, maxiter=400)
    gp.fit_gp(x, y)
    assert rel(gp.mean(xt).numpy(), mu64.numpy()) <= MEAN_RTOL
