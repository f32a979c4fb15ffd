"""Port parity: the rest of GaussianProcess's public surface in
stpy_tpu_torch (`add_data_point`, `execute`, `residuals`, `norm`, `embed`,
`get_basis_size`, `sample_and_max`, `sample_iteratively_max`,
`ucb_optimize`, `volume_mean`, `volume_mean_norm`, `isin`,
`gradient_mean_var`, `mean_gradient_hessian`) against stpy_tpu on the
CPU.

The same numpy data (40 points in [−1, 1]², fixed seed) goes through both
packages, JAX in x64 and torch in float64, on an SE kernel. Where the JAX
method draws from a key, both packages are fed the same numpy draws
(`jax.random.uniform` / `normal` and `torch.rand` / `randn` replaced for
the test). Tolerances: 1e-12 relative for what is closed-form algebra on
the same factor (means, Grams, norms, gradients and Hessians, the drawn
paths), 1e-10 for the grid-free Thompson maximum (a draw after D refits on
fantasised lines; 1.4e-12 measured), for the iterative solvers that converge (ucb_optimize's
ascent, volume_mean's FISTA and bisection), and 1e-6 for volume_mean's
logistic relax after two L-BFGS steps: its mean is K*(K + 1e-6 I)⁻¹β,
which lifts β's last bits by up to 1e6 (2.3e-8 measured).
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

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

D = 2
KW = dict(kernel_name="squared_exponential", gamma=0.5, d=D)
BOUNDS = [[-1.0, 1.0]] * D
S = 0.1


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (40, D))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((40, 1))
    return x, y, rng.uniform(-1, 1, (15, D))


@pytest.fixture
def pair(data):
    x, y, _ = data
    jg = JaxGP(kernel=JaxKernel(**KW), s=S, bounds=BOUNDS)
    tg = TorchGP(kernel=TorchKernel(device="cpu", dtype=torch.float64, **KW),
                 s=S, bounds=BOUNDS)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    return jg, tg


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def feed(monkeypatch, jax_name, torch_name, draws):
    """Both packages' `jax_name` / `torch_name` draw the next of `draws`."""
    jit, tit = iter(draws), iter(draws)
    monkeypatch.setattr(jax.random, jax_name,
                        lambda *a, **k: jnp.asarray(next(jit)))
    monkeypatch.setattr(torch, torch_name,
                        lambda *a, **k: torch.as_tensor(next(tit)))


def test_add_data_point_refits_on_the_grown_data(pair, data):
    jg, tg = pair
    _, _, xt = data
    for _ in range(2):
        jg.add_data_point(jnp.asarray(xt[:2]), jnp.ones(2))
        tg.add_data_point(xt[:2], np.ones(2))
    assert tg.x.shape == (44, D)
    assert rel(tg.mean(xt).numpy(), jg.mean(jnp.asarray(xt))) <= 1e-12


def test_execute_residuals_norm_and_isin_match_jax(pair, data):
    jg, tg = pair
    x, _, xt = data
    ks, kss = tg.execute(xt)
    jks, jkss = jg.execute(jnp.asarray(xt))
    assert rel(ks.numpy(), jks) <= 1e-12 and rel(kss.numpy(), jkss) <= 1e-12
    assert rel(tg.residuals(xt, xt[:, :1]).numpy(),
               jg.residuals(jnp.asarray(xt), jnp.asarray(xt[:, :1]))) <= 1e-12
    assert abs(float(tg.norm()) - float(jg.norm())) <= 1e-12 * float(jg.norm())
    for shift, inside in ((1e-4, True), (1e-2, False)):
        assert tg.isin(x[3] + shift) == jg.isin(jnp.asarray(x[3] + shift)) \
            == inside
    unfitted = TorchGP(kernel=TorchKernel(device="cpu", **KW))
    assert unfitted.norm() is None and unfitted.isin(x[0]) is False


@pytest.mark.parametrize("method", ["embed", "get_basis_size"])
def test_embedding_raises_as_jax_for_every_ported_kernel(pair, data, method):
    jg, tg = pair
    args = (data[0],) if method == "embed" else ()
    with pytest.raises(AttributeError, match="finite dimensional"):
        getattr(jg, method)(*(jnp.asarray(a) for a in args))
    with pytest.raises(AttributeError, match="finite dimensional"):
        getattr(tg, method)(*args)


def test_sample_and_max_on_the_same_draws(pair, data, monkeypatch):
    jg, tg = pair
    _, _, xt = data
    feed(monkeypatch, "normal", "randn",
         [np.random.default_rng(8).standard_normal((15, 3))] * 2)
    jx, jv = jg.sample_and_max(jnp.asarray(xt), size=3,
                               key=jax.random.PRNGKey(0))
    tx, tv = tg.sample_and_max(xt, size=3)
    assert tx.shape == (3, D) and tv.shape == (3,)
    assert rel(tx.numpy(), jx) == 0.0 and rel(tv.numpy(), jv) <= 1e-12


@pytest.mark.parametrize("grid_mode", [True, False], ids=["grid", "grid_free"])
def test_sample_iteratively_max_on_the_same_draws(pair, data, monkeypatch,
                                                  grid_mode):
    jg, tg = pair
    x, _, xt = data
    rng = np.random.default_rng(9)
    if grid_mode:
        feed(monkeypatch, "normal", "randn",
             [rng.standard_normal((15, 1))] * 2)
        args = dict(xtest=xt)
    else:
        feed(monkeypatch, "uniform", "rand",
             [rng.uniform(size=(D,)) for _ in range(3)])
        feed(monkeypatch, "normal", "randn",
             [rng.standard_normal((10, 1)) for _ in range(3 * D)])
        args = dict(xtest=None, multistart=3, grid=10)
    js, jv = jg.sample_iteratively_max(
        **{**args, "xtest": None if args["xtest"] is None
           else jnp.asarray(args["xtest"])}, key=jax.random.PRNGKey(0))
    ts, tv = tg.sample_iteratively_max(**args)
    # grid-free, the value is a draw after D refits on fantasised lines
    tol = 1e-12 if grid_mode else 1e-10
    assert rel(ts.numpy(), js) <= tol
    assert abs(float(np.asarray(tv).max()) - float(np.asarray(jv).max())) \
        <= tol * abs(float(np.asarray(jv).max()))
    # the fantasised lines are gone: the data and the fit are restored
    assert torch.equal(tg.x, torch.as_tensor(x)) and tg.A.shape == (40, 1)


@pytest.mark.parametrize("lcb", [False, True])
def test_ucb_optimize_from_the_same_starts(pair, monkeypatch, lcb):
    jg, tg = pair
    feed(monkeypatch, "uniform", "rand",
         [np.random.default_rng(10).uniform(size=(25, D))] * 2)
    jp, jv = jg.ucb_optimize(lcb=lcb)
    tp, tv = tg.ucb_optimize(lcb=lcb)
    assert tp.shape == (D,)
    assert rel(tp.numpy(), jp) <= 1e-10
    assert abs(float(tv) - float(jv)) <= 1e-10 * abs(float(jv))


@pytest.mark.parametrize("hessian", [False, True])
def test_gradient_helpers_match_jax(pair, data, hessian):
    jg, tg = pair
    pt = data[2][0]
    jr = jg.gradient_mean_var(jnp.asarray(pt), hessian=hessian)
    tr = tg.gradient_mean_var(pt, hessian=hessian)
    jm = jg.mean_gradient_hessian(jnp.asarray(pt), hessian=hessian)
    tm = tg.mean_gradient_hessian(pt, hessian=hessian)
    for got, want in ((tr, jr), (tm, jm)):
        if not hessian:
            got, want = [got], [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == tuple(np.shape(w))
            assert rel(g.numpy(), w) <= 1e-12


@pytest.mark.parametrize("kw", [
    dict(relax="relu", scale=0.3),
    dict(relax="relu", optimize_scale=True, bisections=6),
    dict(relax="logistic", scale=0.3, max_iter=2),
], ids=["relu", "relu-scale", "logistic"])
def test_volume_mean_matches_jax(pair, data, kw):
    jg, tg = pair
    xt = data[2]
    want = jg.volume_mean(jnp.asarray(xt), **kw)
    got = tg.volume_mean(xt, **kw)
    tol = 1e-6 if kw["relax"] == "logistic" else 1e-10
    if kw.get("optimize_scale"):
        assert abs(got - float(want)) <= tol * abs(float(want))
    else:
        assert rel(got.numpy(), want) <= tol


def test_volume_mean_norm_and_alias_match_jax(pair, data):
    jg, tg = pair
    xt = data[2]
    w = np.arange(40.0) + 1.0
    want = jg.volume_mean_norm(jnp.asarray(xt), weights=jnp.asarray(w),
                               scale=0.3)
    assert rel(tg.volume_mean_norm(xt, weights=w, scale=0.3).numpy(),
               want) <= 1e-10
    assert rel(tg.volume_mean_cvxpy(xt, weights=w / w.sum(),
                                    scale=0.3).numpy(), want) <= 1e-10
