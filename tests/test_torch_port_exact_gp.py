"""Port parity: the exact-GP slice of stpy_tpu_torch (GaussianProcess,
single tier, double tier at var_refine=0 and at var_refine >= 1) against
stpy_tpu.

The same numpy data (fixed seed) goes through both packages on the CPU (JAX
in x64, torch in float64), where every port wrapper runs its plain PyTorch
version. Tolerances: posterior mean within 1e-8 relative to its largest
entry; std within 1e-6 relative, entry by entry — looser because the
variance k** − q cancels. After `convert.load_fitted_state` both sides share
the JAX factor, and mean_std agrees to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch.ops import launch_counts

from test_torch_port_gram import CASES, LAPLACE_CASES, jax_kernel, torch_kernel

MEAN_RTOL, STD_RTOL, STATE_RTOL = 1e-8, 1e-6, 1e-10
S = 0.1


@pytest.fixture(autouse=True, scope="module")
def pinned_torch_state():
    """Run this module's torch work on one intra-op thread, with float64 as
    the default dtype whatever the files a test worker imported before
    (two other test modules set it when imported); both restored afterwards.

    One thread, because in a fresh process the first multi-threaded call of
    torch's CPU `exp` can return part of its output at reduced accuracy
    (tools/torch_cpu_first_exp.py, torch 2.13.0+cpu on an AVX512 CPU, six
    processes at a time: float64 entries off by up to 3.2e-9 in 4 of 240
    fresh processes, float32 by up to 1.06e-4 in 3 of 60; no second call
    was off, and no single-threaded first call). When this module ran
    first on a worker, that fault moved the port's posterior mean 1.3e-8
    from the JAX package's, above MEAN_RTOL."""
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (96, 3))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((96, 1))
    xt = rng.uniform(-1, 1, (48, 3))
    return x, y, xt


def assert_posterior_close(got, want, mean_rtol=MEAN_RTOL, std_rtol=STD_RTOL):
    (tm, ts), (jm, js) = got, want
    tm, ts = tm.numpy(), ts.numpy()
    jm, js = np.asarray(jm), np.asarray(js)
    assert tm.shape == jm.shape and ts.shape == js.shape
    assert np.max(np.abs(tm - jm)) / np.max(np.abs(jm)) <= mean_rtol
    assert np.max(np.abs(ts - js) / js) <= std_rtol


def gp_pair(case, **kw):
    return (JaxGP(kernel=jax_kernel(case), s=S, **kw),
            TorchGP(kernel=torch_kernel(case), s=S, **kw))


@pytest.mark.parametrize("case", CASES)
def test_single_tier_fit_gp_mean_std_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert tg.fit_status == jg.fit_status | {"jitter_used": tg.fit_status["jitter_used"]}
    assert tg.fit_status["jitter_used"] == pytest.approx(
        jg.fit_status["jitter_used"], rel=1e-12)
    # Matérn-½ Gram diagonals are 1 − √δ, δ ~ 1e-16 being each side's own
    # cancellation residual of |x|² + |x|² − 2x·x (test_torch_port_gram), so
    # the two factored matrices differ by ~3e-8 there and the means by ~1e-8
    mean_rtol = 1e-7 if case == "matern12" else MEAN_RTOL
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)),
                           mean_rtol)


@pytest.mark.parametrize("case", ["se", "matern32"])
def test_single_tier_fit_predict_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, jitter_ladder=False)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    # state is stored exactly as after fit_gp
    assert_posterior_close(tg.mean_std(xt), want)


@pytest.mark.parametrize("case", LAPLACE_CASES)
def test_laplace_single_tier_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_full_covariance_matches_jax(data):
    x, y, xt = data
    jg, tg = gp_pair("matern52")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    (tm, tc), (jm, jc) = tg.mean_std(xt, full=True), jg.mean_std(
        jnp.asarray(xt), full=True)
    assert np.max(np.abs(tm.numpy() - np.asarray(jm))) <= MEAN_RTOL
    # the covariance is the k** − VᵀV cancellation, as the std
    assert np.max(np.abs(tc.numpy() - np.asarray(jc))) <= 1e-10


def test_unfitted_prior_matches_jax(data):
    _, _, xt = data
    jg, tg = gp_pair("se*matern12")
    tm, ts = tg.mean_std(xt)
    jm, js = jg.mean_std(jnp.asarray(xt))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.allclose(ts.numpy(), np.asarray(js), rtol=1e-14)


def test_sigma_noise_fit_matches_jax(data):
    x, y, xt = data
    sigma = np.diag(np.random.default_rng(8).uniform(0.05, 0.2, 96))
    jg, tg = gp_pair("ard")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y), Sigma=jnp.asarray(sigma))
    tg.fit_gp(x, y, Sigma=sigma)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))
    _, tdouble = gp_pair("ard", precision="double")
    with pytest.raises(NotImplementedError):
        tdouble.fit_gp(x, y, Sigma=sigma)


def test_ucb_lcb_beta_match_jax(data):
    x, y, xt = data
    jg, tg = gp_pair("se")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert float(tg.beta()) == pytest.approx(float(jg.beta()), rel=1e-10)
    for name in ("ucb", "lcb"):
        got = getattr(tg, name)(xt).numpy()
        want = np.asarray(getattr(jg, name)(jnp.asarray(xt)))
        assert np.max(np.abs(got - want)) <= 1e-7


def test_refit_releases_previous_fit(data):
    x, y, xt = data
    tg = TorchGP(kernel=torch_kernel("se"), s=S)
    tg.fit_gp(x, y)
    first = tg.L
    tg.fit_gp(x[:50], y[:50])
    assert tg.L is not first and tg.L.shape == (50, 50)
    assert tg.fit_status == {"cholesky_ok": True, "n": 50,
                             "jitter_used": tg.fit_status["jitter_used"]}
    tg.load_data((x, y))
    tg.fit()
    assert tg.n == 96


def test_cpu_tensors_leave_every_launch_counter_at_zero(data):
    x, y, xt = data
    before = launch_counts()
    for case, kw in (("se+matern32", dict(precision="single")),
                     ("se+matern32", dict(precision="double")),
                     ("se+matern32", dict(precision="double", var_refine=1)),
                     ("laplace", dict(precision="single"))):
        TorchGP(kernel=torch_kernel(case, dtype=torch.float32), s=S,
                **kw).fit_predict(x, y, xt)
    assert launch_counts() == before == {
        "gram": 0, "gram_df": 0, "gemv_df": 0, "qform_df": 0, "gram_l1": 0,
        "gram_matvec": 0, "gram_matvec[dk_sq]": 0, "gram_matvec[dk]": 0,
        "gram_matmat": 0, "gram_matmat[dk_sq]": 0, "gram_matmat[dk]": 0,
        "syrk_lower": 0, "chol_leaf": 0, "gram_df_stages": 0,
        "gram_df[stage]": 0}
