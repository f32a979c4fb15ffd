"""Port parity: `KernelizedFeatures`, `GaussianProcessFF` and
`TruncatedKernelizedFeatures` of stpy_tpu_torch/models against stpy_tpu on
the CPU, mirroring tests/test_feature_gp.py and the GaussianProcessFF /
TruncatedKernelizedFeatures cases of tests/test_aux_components.py.

The same numpy data (50 points of sin 3x + noise, fixed seed) go through
both packages, JAX in x64 and torch in float64, on the same Hermite
embedding (its frequencies are built in numpy, identical in both). Where
the JAX method draws from a key, both packages are fed the same numpy
draws (`feed`). Tolerances, relative to the largest entry: 1e-12 for
closed-form algebra on the same matrices (β, log-determinants, kernels);
1e-10 where the posterior mean enters (the port refines θ̂ once on the
data residual, which moves it by cond(V)·eps ≈ 1e-11, see
models/feature_gp.py) or an ill-conditioned matrix is inverted (the
rank-1 updates, the Matheron correction's K + s²I); 1e-9 for the dual
fit's std, λ⁻¹(1 − qᵀK⁻¹q) entry by entry, which cancels to ~1e-3 of its
terms on K⁻¹ of condition ~n/s² = 2e4; 1e-8 for the iterative estimators
(FISTA, the projected ascent of `ucb_optimize`), which repeat the JAX
iterates to their own rounding; 1e-6 for the L-BFGS ones, held by their
fit Qθ; and 1e-4 for the min-norm interpolant's fit Qθ: its θ reaches 1e9
on singular values near the cut, so Qθ cancels terms of 1e9 and both
packages' SVDs move it by ~1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import HermiteEmbedding as JaxHermite
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.models import (
    GaussianProcessFF as JaxFF,
    KernelizedFeatures as JaxKF,
    TruncatedKernelizedFeatures as JaxTrunc,
)
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_feature_state
from stpy_tpu_torch.embeddings import HermiteEmbedding as TorchHermite
from stpy_tpu_torch.models import (
    GaussianProcessFF as TorchFF,
    KernelizedFeatures as TorchKF,
    TruncatedKernelizedFeatures as TorchTrunc,
)

from test_torch_port_gp_methods import feed
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def data1d():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (50, 1))
    y = np.sin(3 * x) + 0.05 * rng.standard_normal((50, 1))
    return x, y, np.linspace(-1, 1, 32)[:, None]


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def pair(x, y, m=64, s=0.05, primal=True, **kw):
    """(JAX, port) feature GPs on the same Hermite(0.5, m) embedding,
    fitted on (x, y) where x is given."""
    je, te = JaxHermite(gamma=0.5, m=m, d=1), TorchHermite(gamma=0.5, m=m, d=1,
                                                           **F64)
    jf = JaxKF(embedding=je, m=je.get_m(), s=s, lam=1.0, primal=primal, d=1,
               **kw)
    tf = TorchKF(embedding=te, m=te.get_m(), s=s, lam=1.0, primal=primal, d=1,
                 **kw)
    if x is not None:
        jf.fit_gp(jnp.asarray(x), jnp.asarray(y))
        tf.fit_gp(x, y)
    return jf, tf


def assert_posterior(tf, jf, xt, rtol=1e-10):
    (tm, ts), (jm, js) = tf.mean_std(xt), jf.mean_std(jnp.asarray(xt))
    assert rel(tm.numpy(), jm) <= rtol and rel(ts.numpy(), js) <= rtol


@pytest.mark.parametrize("primal", [True, False])
def test_fit_matches_jax(data1d, primal):
    x, y, xt = data1d
    jf, tf = pair(x, y, m=128, primal=primal)
    assert tf.dual == jf.dual == (not primal)
    assert_posterior(tf, jf, xt, 1e-10 if primal else 1e-9)
    tm, Z = tf.theta_mean(var=True)
    jtm, jZ = jf.theta_mean(var=True)
    assert rel(tm.numpy(), jtm) <= 1e-10 and rel(Z.numpy(), jZ) <= 1e-10


def test_primal_and_dual_agree(data1d):
    x, y, xt = data1d
    _, tp = pair(x, y, m=128, primal=True)
    _, td = pair(x, y, m=128, primal=False)
    (mp, sp), (md, sd) = tp.mean_std(xt), td.mean_std(xt)
    assert torch.allclose(mp, md, atol=1e-6) and torch.allclose(sp, sd,
                                                                atol=1e-6)


@pytest.mark.parametrize("primal,n0,n1", [(True, 44, 50), (False, 20, 25)])
def test_add_data_point_matches_jax_and_the_refit(data1d, primal, n0, n1):
    """Sherman–Morrison on V⁻¹ (primal) and Schur growth of K⁻¹ (dual)."""
    x, y, xt = data1d
    jf, tf = pair(x[:n0], y[:n0], m=128, primal=primal)
    for i in range(n0, n1):
        jf.add_data_point(jnp.asarray(x[i:i + 1]), jnp.asarray(y[i:i + 1]))
        tf.add_data_point(x[i:i + 1], y[i:i + 1])
    assert_posterior(tf, jf, xt, 1e-10 if primal else 1e-9)
    _, ref = pair(x[:n1], y[:n1], m=128, primal=primal)
    assert torch.allclose(tf.mean(xt), ref.mean(xt), atol=1e-7)


def test_streamed_fit_matches_jax_and_the_in_memory_fit():
    rng = np.random.default_rng(71)
    x = rng.uniform(-1, 1, (500, 1))
    y = np.sin(3 * x) + 0.05 * rng.standard_normal((500, 1))
    xt = rng.uniform(-1, 1, (64, 1))
    jf, tf = pair(None, None, m=64, s=0.1)
    jf.fit_gp_streamed(jnp.asarray(x), jnp.asarray(y), chunk=128)
    tf.fit_gp_streamed(x, y, chunk=128)       # 500 rows: 3 chunks and 116
    assert tf.Q is None
    assert_posterior(tf, jf, xt)
    _, ref = pair(x, y, m=64, s=0.1)
    assert torch.allclose(tf.mean(xt), ref.mean(xt), atol=1e-9)
    assert torch.allclose(tf.mean_std(xt)[1], ref.mean_std(xt)[1], atol=1e-9)
    xn = np.array([[0.33]])
    jf.add_data_point(jnp.asarray(xn), jnp.sin(3 * jnp.asarray(xn)))
    tf.add_data_point(xn, np.sin(3 * xn))
    assert tf.Q is None and tf._Qty is not None
    assert_posterior(tf, jf, xt, 1e-10)


def test_sampling_on_fed_draws_matches_jax(data1d, monkeypatch):
    x, y, xt = data1d
    jf, tf = pair(x, y, m=64)
    z = np.random.default_rng(3).standard_normal((64, 5))
    feed(monkeypatch, "normal", "randn", [z] * 4)
    assert rel(tf.sample(xt, size=5).numpy(),
               jf.sample(jnp.asarray(xt), size=5,
                         key=jax.random.PRNGKey(0))) <= 1e-10
    assert rel(tf.sample_theta(size=5).numpy(),
               jf.sample_theta(size=5, key=jax.random.PRNGKey(0))) <= 1e-10
    k = dict(kernel_name="squared_exponential", gamma=0.5, d=1)
    got = tf.sample_matheron(xt, TorchKernel(**k, **F64), size=5)
    want = jf.sample_matheron(jnp.asarray(xt), JaxKernel(**k), size=5,
                              key=jax.random.PRNGKey(1))
    assert rel(got.numpy(), want) <= 1e-10
    feed(monkeypatch, "normal", "randn", [z[:, :2]] * 2)
    px, pv = tf.sample_and_max(xt, size=2)
    jx, jv = jf.sample_and_max(jnp.asarray(xt), size=2,
                               key=jax.random.PRNGKey(2))
    assert rel(px.numpy(), jx) == 0 and rel(pv.numpy(), jv) <= 1e-10


def test_sample_moments_on_torch_draws(data1d):
    """The port's own draws (a seeded generator) center on the posterior."""
    x, y, xt = data1d
    _, tf = pair(x, y, m=64)
    f = tf.sample(xt, size=3000, generator=torch.Generator().manual_seed(0))
    mu, std = tf.mean_std(xt)
    assert (f.mean(dim=1) - mu[:, 0]).abs().max() < 0.05
    assert (f.std(dim=1) - std[:, 0]).abs().max() < 0.05


def test_beta_logdet_and_effective_dim_match_jax(data1d):
    x, y, xt = data1d
    jf, tf = pair(x, y, m=64)
    assert float(tf.beta()) == float(jf.beta()) == 2.0
    jf.beta_fun = tf.beta_fun = "theory"
    assert abs(float(tf.beta(delta=0.1)) - float(jf.beta(delta=0.1))) \
        <= 1e-12 * abs(float(jf.beta(delta=0.1)))
    assert rel(tf.ucb(xt).numpy(), jf.ucb(jnp.asarray(xt))) <= 1e-10
    assert rel(tf.lcb(xt).numpy(), jf.lcb(jnp.asarray(xt))) <= 1e-10
    assert abs(float(tf.logdet_ratio()) - float(jf.logdet_ratio())) \
        <= 1e-12 * abs(float(jf.logdet_ratio()))
    ed, jed = float(tf.effective_dim(x)), float(jf.effective_dim(
        jnp.asarray(x)))
    assert 0 < ed < 64 and abs(ed - jed) <= 1e-12 * jed
    assert rel(tf.kernel(x[:5], x[:3]).numpy(),
               jf.kernel(jnp.asarray(x[:5]), jnp.asarray(x[:3]))) <= 1e-12
    assert tf.kernel(x[:5], x[:3]).shape == (3, 5)
    assert rel(tf.get_kernel().numpy(), jf.get_kernel()) <= 1e-12
    assert abs(float(tf.residuals()) - float(jf.residuals())) \
        <= 1e-10 * float(jf.residuals())


def test_constrained_theta_estimators_match_jax(data1d):
    x, y, _ = data1d
    jf, tf = pair(x, y, m=128)
    t1 = tf.theta_mean_constrained(B=1.0)
    assert float(torch.linalg.vector_norm(t1)) <= 1.0 + 1e-6
    assert rel(t1.numpy(), jf.theta_mean_constrained(B=1.0)) <= 1e-8
    assert rel(tf.theta_absolute_deviation_constrained(B=1.0).numpy(),
               jf.theta_absolute_deviation_constrained(B=1.0)) <= 1e-8
    t3 = tf.interpolation()
    Q = tf.embed(x).numpy()
    assert rel(Q @ t3.numpy(), np.asarray(Q @ jf.interpolation())) <= 1e-4
    assert np.abs(Q @ t3.numpy() - y).max() < 0.15
    t2 = tf.theta_absolute_deviation()
    assert rel((tf.embed(x) @ t2).numpy(),
               np.asarray(jf.embed(jnp.asarray(x)) @
                          jf.theta_absolute_deviation())) <= 1e-6
    t4 = tf.theta_chebyschev_approximation(eps=0.2)
    assert np.abs(Q @ t4.numpy() - y).max() < 0.3
    j4 = jf.theta_chebyschev_approximation(eps=0.2)
    assert rel((tf.embed(x) @ t4).numpy(),
               np.asarray(jf.embed(jnp.asarray(x)) @ j4)) <= 1e-6


def test_ucb_optimize_and_thompson_match_jax(data1d, monkeypatch):
    x, y, _ = data1d
    jf, tf = pair(x, y, m=64)
    jf.bounds = tf.bounds = [[-1.0, 1.0]]
    u = np.random.default_rng(9).uniform(0, 1, (8, 1))
    feed(monkeypatch, "uniform", "rand", [u])
    pt, val = tf.ucb_optimize(beta=2.0, multistart=8)
    jpt, jval = jf.ucb_optimize(beta=2.0, multistart=8)
    assert pt.shape == (1, 1) and abs(float(pt[0, 0]) - np.pi / 6) < 0.2
    assert rel(pt.numpy(), jpt) <= 1e-8 and rel(val.numpy(), jval) <= 1e-8
    z = np.random.default_rng(10).standard_normal((64, 1))
    feed(monkeypatch, "normal", "randn", [z])
    feed(monkeypatch, "uniform", "rand", [u])
    pt2, val2 = tf.sample_and_optimize(multistart=8)
    jpt2, jval2 = jf.sample_and_optimize(multistart=8,
                                         key=jax.random.PRNGKey(3))
    assert -1.0 <= float(pt2[0]) <= 1.0
    assert rel(pt2.numpy(), jpt2) <= 1e-8 and rel(val2.numpy(), jval2) <= 1e-8


def test_state_carried_from_jax_serves_the_same_posterior(data1d):
    x, y, xt = data1d
    jf, _ = pair(x, y, m=64)
    _, tf = pair(None, None, m=64)
    load_feature_state(tf, x, y, Q=np.asarray(jf.Q), V=np.asarray(jf.V),
                       invV=np.asarray(jf.invV))
    assert_posterior(tf, jf, xt)
    jd, _ = pair(x[:20], y[:20], m=128, primal=False)
    _, td = pair(None, None, m=128, primal=False)
    load_feature_state(td, x[:20], y[:20], Q=np.asarray(jd.Q),
                       K=np.asarray(jd.K), invK=np.asarray(jd.invK),
                       invK_V=np.asarray(jd.invK_V))
    assert td.dual
    assert_posterior(td, jd, xt)


@pytest.mark.parametrize("approx,groups", [
    ("hermite", None), ("rff", None), ("quad", None), ("hermite", [[0], [1]]),
])
def test_gaussian_process_ff_matches_jax(approx, groups):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (40, 2))
    y = np.sin(3 * x[:, :1]) + x[:, 1:]
    kw = dict(gamma=0.5, s=0.1, m=128 if groups is None else 64, d=2,
              approx=approx, groups=groups)
    jf, tf = JaxFF(**kw), TorchFF(**kw, **F64)
    jf.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tf.fit_gp(x, y)
    mu, _ = tf.mean_std(x)
    assert np.abs(mu.numpy() - y).mean() < 0.2
    assert_posterior(tf, jf, x, 1e-10)


def test_truncated_features_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (40, 1))
    y = np.sin(3 * x)
    y[5] = 100.0  # an outlier beyond the threshold
    je, te = JaxHermite(gamma=0.5, m=32, d=1), TorchHermite(gamma=0.5, m=32,
                                                            d=1, **F64)
    jt = JaxTrunc(je, m=32, s=0.1, default_alpha_score=2.0)
    tt = TorchTrunc(te, m=32, s=0.1, default_alpha_score=2.0)
    jt.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tt.fit_gp(x, y)
    mu, _ = tt.mean_std(x)
    clean = np.delete(np.arange(40), 5)
    assert np.abs(mu.numpy()[clean] - y[clean]).mean() < 0.2
    assert_posterior(tt, jt, x)
    jt.add_data_point(jnp.asarray([[0.2]]), jnp.asarray([[1.5]]))
    tt.add_data_point([[0.2]], [[1.5]])
    assert_posterior(tt, jt, x)
