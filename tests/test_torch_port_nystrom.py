"""Port parity: `NystromFeatures` of stpy_tpu_torch/embeddings/nystrom.py
against stpy_tpu on the CPU, for every `approx`, and the slice as a whole:
benchmarks/run_all.py's config 3 (the additive Matérn-3/2 + SE Nyström
ridge, cut to n = 2000 and m = 64) and config 2 as written (n = 512, the
Hermite(0.5, 512, 2) feature GP with its m = 484 features against the
exact GP, 1024 test points, 64 draws).

The same numpy data go through both packages, JAX in x64 and torch in
float64. Where the JAX package draws from a key (the landmarks of
`jax.random.choice`, the online pass's uniforms, the positive basis's
prior draws and NMF start, the feature GP's normals), both packages are
fed the same draws. Tolerances, relative to the largest entry: 1e-12 for
the exact GP and the feature GP (closed-form algebra on the same
matrices); 1e-10 for the leverage weights (the scores cancel k_jj against
k_jᵀ(K + s²I)⁻¹k_j); 1e-9 for the Nyström posteriors: their landmark Grams carry
eigenvalues down to the 1e-14 cut, weighted by up to 1e7, where two
LAPACK eigensolvers' eigenvectors differ by rounding (1e-16·λmax), which
moves the features by ~1e-9; 1e-6 for the positive basis, whose NMF runs
300 multiplicative updates on prior draws factored with jitter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import HermiteEmbedding as JaxHermite
from stpy_tpu.embeddings import NystromFeatures as JaxNystrom
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu.models import KernelizedFeatures as JaxKF
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_nystrom_state
from stpy_tpu_torch.embeddings import HermiteEmbedding as TorchHermite
from stpy_tpu_torch.embeddings import NystromFeatures as TorchNystrom
from stpy_tpu_torch.embeddings import nystrom as tny
from stpy_tpu_torch.models import KernelizedFeatures as TorchKF

from test_torch_port_gp_methods import feed
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
NYSTROM_RTOL = 1e-9


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def config3_kernels(place=None):
    """run_all.py config 3's kernel: Matérn-3/2(0.4) on x₀ + SE(0.6) on x₁."""
    mk = [(JaxKernel, {}), (TorchKernel, place or F64)]
    return [cls(kernel_name="matern", gamma=0.4, nu=1.5, d=2, group=[0], **p)
            + cls(kernel_name="squared_exponential", gamma=0.6, d=2,
                  group=[1], **p) for cls, p in mk]


def config3_data(n, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    return x, np.sin(3 * x[:, :1]) + x[:, 1:]


def feed_landmarks(monkeypatch, C):
    """Both packages' landmark choice returns C."""
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **k: jnp.asarray(C))
    monkeypatch.setattr(tny, "_choice",
                        lambda g, n, k, p=None: torch.as_tensor(C))


def fit_pair(approx, x, y, m, monkeypatch=None, C=None, **kw):
    jk, tk = config3_kernels()
    jn = JaxNystrom(jk, m=m, approx=approx, s=0.05, **kw)
    tn = TorchNystrom(tk, m=m, approx=approx, s=0.05, **kw)
    if C is not None:
        feed_landmarks(monkeypatch, C)
    jn.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tn.fit_gp(x, y)
    return jn, tn


def assert_posterior(tn, jn, xt, rtol=NYSTROM_RTOL):
    (tm, ts), (jm, js) = tn.mean_std(xt), jn.mean_std(jnp.asarray(xt))
    assert rel(tm.numpy(), jm) <= rtol and rel(ts.numpy(), js) <= rtol


@pytest.mark.parametrize("approx", ["uniform", "leverage"])
def test_landmark_approx_on_the_same_landmarks_matches_jax(approx,
                                                           monkeypatch):
    x, y = config3_data(300)
    C = np.random.default_rng(0).choice(300, 24, replace=False)
    jn, tn = fit_pair(approx, x, y, 24, monkeypatch, C)
    assert np.array_equal(tn.C.numpy(), C)
    assert_posterior(tn, jn, x[:64])
    assert rel(tn.embed(x[:8]) @ tn.embed(x[:8]).T,
               np.asarray(jn.embed(jnp.asarray(x[:8]))
                          @ jn.embed(jnp.asarray(x[:8])).T)) <= NYSTROM_RTOL
    assert rel(tn.outer_kernel().numpy(), jn.outer_kernel()) <= NYSTROM_RTOL
    if approx == "leverage":
        # the importance weights 1/√(ms·p_C) from both packages' scores
        jk, tk = config3_kernels()
        tw = TorchNystrom(tk, m=24, approx=approx,
                          s=0.05).leverage_score_subsampling(
            torch.tensor(x), None)[1]
        jw = JaxNystrom(jk, m=24, approx=approx,
                        s=0.05).leverage_score_subsampling(
            jnp.asarray(x), None)[1]
        assert rel(tw.numpy(), jw) <= 1e-10


def test_online_leverage_on_the_same_uniforms_matches_jax(monkeypatch):
    x, y = config3_data(24)
    us = np.random.default_rng(1).uniform(0, 1, 24)
    feed(monkeypatch, "uniform", "rand", [us])
    jn, tn = fit_pair("online_leverage", x, y, 4)
    assert np.array_equal(tn.C.numpy(), np.asarray(jn.C))
    assert_posterior(tn, jn, x)


@pytest.mark.parametrize("approx", ["svd", "nothing", "cover"])
def test_full_data_approx_matches_jax(approx):
    x, y = config3_data(80)
    jn, tn = fit_pair(approx, x, y, 16)
    assert_posterior(tn, jn, x[:30])


def test_positive_svd_on_the_same_draws_matches_jax(monkeypatch):
    x = np.linspace(-1, 1, 30)[:, None]
    y = np.zeros((30, 1))
    rng = np.random.default_rng(2)
    z = rng.standard_normal((30, 20))
    W0, H0 = rng.uniform(0, 1, (30, 4)), rng.uniform(0, 1, (4, 20))
    feed(monkeypatch, "normal", "randn", [z])
    feed(monkeypatch, "uniform", "rand", [W0, H0])
    k = dict(kernel_name="squared_exponential", gamma=0.3, d=1)
    jn = JaxNystrom(JaxKernel(**k), m=4, approx="positive_svd", samples=20)
    tn = TorchNystrom(TorchKernel(**k, **F64), m=4, approx="positive_svd",
                      samples=20)
    jn.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tn.fit_gp(x, y)
    q = np.linspace(-1.2, 1.2, 41)[:, None]
    got = tn.embed(q).numpy()
    assert np.all(got >= 0)
    assert rel(got, jn.embed(jnp.asarray(q))) <= 1e-6


def test_sample_theta_on_fed_draws_matches_jax(monkeypatch):
    """The landmark map's eigenvectors carry a sign each, which the two
    packages' eigensolvers choose independently: the port is fed the same
    normals with each feature's sign, found by comparing the features, and
    the draws θ and the drawn functions Φθ are held."""
    x, y = config3_data(200)
    C = np.arange(0, 200, 10)
    jn, tn = fit_pair("uniform", x, y, 20, monkeypatch, C)
    je = np.asarray(jn.embed(jnp.asarray(x[:50])))
    te = tn.embed(x[:50]).numpy()
    sign = np.sign(np.sum(je * te, axis=0))
    assert rel(te * sign, je) <= NYSTROM_RTOL
    z = np.random.default_rng(3).standard_normal((20, 4))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(z))
    monkeypatch.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(
        z * sign[:, None]))
    theta = tn.sample_theta(size=4).numpy()
    jtheta = jn.sample_theta(size=4, key=jax.random.PRNGKey(0))
    assert rel(theta * sign[:, None], jtheta) <= NYSTROM_RTOL
    assert rel(te @ theta, je @ np.asarray(jtheta)) <= NYSTROM_RTOL


def test_state_carried_from_jax_serves_the_same_posterior(monkeypatch):
    x, y = config3_data(200)
    C = np.arange(0, 200, 8)
    jn, _ = fit_pair("uniform", x, y, 25, monkeypatch, C)
    _, tk = config3_kernels()
    tn = TorchNystrom(tk, m=25, approx="uniform", s=0.05)
    load_nystrom_state(tn, x, y, C=np.asarray(jn.C), xs=np.asarray(jn._xs),
                       Wmat=np.asarray(jn._Wmat), L=np.asarray(jn._L),
                       theta=np.asarray(jn._theta))
    assert_posterior(tn, jn, x[:50], 1e-12)


def test_config3_at_reduced_n_matches_jax(monkeypatch):
    """run_all.py config 3's kernel, formula and approx at n = 2000,
    m = 64: fit, `mean_std` on the first 256 points and train_mae_head, on
    the same landmarks; also the eigenvalue counts that trouble a float32
    fit (the cut at 1e-14, the eigenvalues under 1e-6·λmax)."""
    x, y = config3_data(2000)
    C = np.random.default_rng(5).choice(2000, 64, replace=False)
    jn, tn = fit_pair("uniform", x, y, 64, monkeypatch, C)
    assert_posterior(tn, jn, x[:256])
    mae = float((tn.mean_std(x[:256])[0] - torch.tensor(y[:256])).abs()
                .mean())
    jmae = float(jnp.abs(jn.mean_std(jnp.asarray(x[:256]))[0]
                         - y[:256]).mean())
    assert abs(mae - jmae) <= 1e-9 * jmae and mae < 0.05
    eigs = tn.eigs
    assert eigs.dtype == torch.float64
    assert int((eigs > tny.EIG_CUT).sum()) <= 64


def test_config2_as_written_matches_jax(monkeypatch):
    """run_all.py config 2 (:94-127): the exact GP, then HermiteEmbedding
    (0.5, 512, 2) with KernelizedFeatures at s = 0.05: fit, mean_std at
    1024 points and 64 draws, and the two errors against the exact GP."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (512, 2))
    y = np.sin(3 * x[:, :1]) * np.cos(2 * x[:, 1:])
    xt = rng.uniform(-1, 1, (1024, 2))
    jg = JaxGP(gamma=0.5, s=0.05, d=2, var_precision=jax.lax.Precision.HIGHEST)
    tg = TorchGP(gamma=0.5, s=0.05, d=2, device="cpu", dtype=torch.float64)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    (mu_e, std_e), (jmu_e, jstd_e) = tg.mean_std(xt), jg.mean_std(
        jnp.asarray(xt))
    assert rel(mu_e.numpy(), jmu_e) <= 1e-12 and rel(std_e.numpy(),
                                                     jstd_e) <= 1e-9
    je, te = JaxHermite(gamma=0.5, m=512, d=2), TorchHermite(gamma=0.5, m=512,
                                                             d=2, **F64)
    assert te.get_m() == je.get_m() == 484
    jf = JaxKF(embedding=je, m=je.get_m(), s=0.05, d=2)
    tf = TorchKF(embedding=te, m=te.get_m(), s=0.05, d=2)
    jf.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tf.fit_gp(x, y)
    (mu, std), (jmu, jstd) = tf.mean_std(xt), jf.mean_std(jnp.asarray(xt))
    assert rel(mu.numpy(), jmu) <= 1e-10 and rel(std.numpy(), jstd) <= 1e-10
    z = np.random.default_rng(0).standard_normal((484, 64))
    feed(monkeypatch, "normal", "randn", [z])
    f = tf.sample(xt, size=64)
    assert f.shape == (1024, 64)
    assert rel(f.numpy(), jf.sample(jnp.asarray(xt), size=64,
                                    key=jax.random.PRNGKey(0))) <= 1e-10
    mu_err = float((mu - mu_e).abs().max())
    std_err = float((std - std_e).abs().max())
    assert abs(mu_err - float(jnp.abs(jmu - jmu_e).max())) <= 1e-9
    assert abs(std_err - float(jnp.abs(jstd - jstd_e).max())) <= 1e-9
    # the quadrature features approximate the exact posterior closely
    assert mu_err < 1e-3 and std_err < 1e-3
