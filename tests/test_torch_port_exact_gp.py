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

from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch.convert import load_fitted_state, params_from_jax
from stpy_tpu_torch.kernels import df_plan
from stpy_tpu_torch.ops import launch_counts
from stpy_tpu_torch.opt import minimize_lbfgs

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


@pytest.mark.parametrize("case", CASES)
def test_double_tier_fit_predict_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double")
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    assert tg._df_refine_steps_resolved == jg._df_refine_steps_resolved == 1
    # alpha is kept as the (n, 2) df pair, self.A its hi column
    assert tg._A_df.shape == (96, 2)
    assert torch.equal(tg.A, tg._A_df[:, :1])


@pytest.mark.parametrize("case", CASES)
def test_var_refine_fit_predict_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double", var_refine=1)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    # the train df Gram is kept for the quadratic form, as in the JAX GP
    got = sum(k.numpy() for k in tg._df_train)
    want = sum(np.asarray(k) for k in jg._df_train)
    assert np.max(np.abs(got - want) / want) <= 1e-13


@pytest.mark.parametrize("case", CASES)
def test_var_refine_fit_gp_then_mean_std_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case, precision="double", var_refine=1)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_var_refine_above_one_acts_as_one(data):
    x, y, xt = data
    one = TorchGP(kernel=torch_kernel("se+matern32"), s=S, precision="double",
                  var_refine=1).fit_predict(x, y, xt)
    two = TorchGP(kernel=torch_kernel("se+matern32"), s=S, precision="double",
                  var_refine=2).fit_predict(x, y, xt)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_var_refine_tightens_the_variance_over_var_refine_zero(data):
    """Against a float64 posterior on the same f32-rounded Gram pair, the
    refined variance is exact to the df floor while the var_refine=0
    variance goes through the hi part only."""
    x, y, xt = data
    errs = {}
    for vr in (0, 1):
        tg = TorchGP(kernel=torch_kernel("matern32"), s=S, precision="double",
                     var_refine=vr)
        _, sd = tg.fit_predict(x, y, xt)
        K = tg.kernel_object.cross(x, x).numpy() + S * S * np.eye(96)
        Ks = tg.kernel_object.cross(xt, x).numpy()
        var = 1.0 - np.einsum("tn,nt->t", Ks, np.linalg.solve(K, Ks.T))
        errs[vr] = np.max(np.abs(sd.numpy()[:, 0] ** 2 - var) / var)
    assert errs[1] <= 1e-9 < errs[0]


@pytest.mark.parametrize("case", CASES)
def test_df_diag_from_desc_matches_jax(case):
    xt = np.random.default_rng(9).uniform(-1, 1, (70, 3))
    jk, tk = jax_kernel(case), torch_kernel(case)
    jh, jl = jax_df_plan.df_diag_from_desc(
        jk, jk.params_dict, jnp.asarray(xt), jax_df_plan.df_atom_desc(jk),
        chunk=32)
    th, tl = df_plan.df_diag_from_desc(
        tk, tk.params_dict, torch.as_tensor(xt), df_plan.df_atom_desc(tk),
        chunk=32)
    got = th.double().numpy() + tl.double().numpy()
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    assert th.shape == (70,) and np.max(np.abs(got - want) / want) <= 1e-13


@pytest.mark.parametrize("case", LAPLACE_CASES)
def test_laplace_single_tier_matches_jax(data, case):
    x, y, xt = data
    jg, tg = gp_pair(case)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    assert_posterior_close(tg.fit_predict(x, y, xt), want)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


@pytest.mark.parametrize("case", LAPLACE_CASES)
def test_double_tier_laplace_is_the_float64_l1_posterior(data, case):
    """The double tier of a kernel with a laplace atom runs the L1 family
    of the double-float Gram (the single tier's kernel; the JAX package's
    double tier computes an L2 Matérn-½ there, ROADMAP Queue 3): its
    posterior at var_refine=1 is the float64 model's on the L1 Gram, to
    the f32 floor of the returned mean and std (1e-7)."""
    x, y, xt = data
    x, xt = (np.asarray(a, np.float32).astype(np.float64) for a in (x, xt))
    want = TorchGP(kernel=torch_kernel(case), s=S).fit_predict(x, y, xt)
    tg = TorchGP(kernel=torch_kernel(case, dtype=torch.float32), s=S,
                 precision="double", var_refine=1)
    assert [d[1] for d in tg._df_desc].count("laplace") == 1
    assert_posterior_close(tg.fit_predict(x, y, xt), want, mean_rtol=1e-7,
                           std_rtol=1e-6)


def test_double_tier_fit_gp_then_mean_std_matches_jax(data):
    x, y, xt = data
    jg, tg = gp_pair("ard*matern52", precision="double", df_refine_steps=2)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


@pytest.mark.parametrize("precision,var_refine", [
    ("single", 0), ("double", 0), ("double", 1)])
def test_mean_std_on_loaded_jax_state(data, precision, var_refine):
    x, y, xt = data
    kw = dict(s=S, precision=precision, var_refine=var_refine)
    jg = JaxGP(kernel=jax_kernel("se+matern32"), **kw)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg = TorchGP(kernel=torch_kernel("se+matern32"), **kw)
    tg.kernel_object.set_params(params_from_jax(
        {k: {n: np.asarray(v) for n, v in p.items()}
         for k, p in jg.kernel_object.params_dict.items()}))
    load_fitted_state(
        tg, np.asarray(jg.x), np.asarray(jg.y), np.asarray(jg.L),
        np.asarray(jg.A),
        A_df=None if jg._A_df is None else np.asarray(jg._A_df),
        df_train=(None if jg._df_train is None
                  else [np.asarray(k) for k in jg._df_train]))
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)),
                           STATE_RTOL, STATE_RTOL)


def test_loading_a_var_refine_state_needs_the_train_df_gram(data):
    x, y, _ = data
    tg = TorchGP(kernel=torch_kernel("se"), s=S, precision="double",
                 var_refine=1)
    with pytest.raises(ValueError, match="df_train"):
        load_fitted_state(tg, x, y, np.eye(96), y, A_df=np.zeros((96, 2)))


def test_params_from_jax_keeps_float64_values():
    jk = jax_kernel("ard*matern52")
    pd = params_from_jax({k: {n: np.asarray(v) for n, v in p.items()}
                          for k, p in jk.params_dict.items()})
    assert set(pd) == {"0", "1"} and set(pd["0"]) == {"kappa", "ard_gamma"}
    for k, p in jk.params_dict.items():
        for n, v in p.items():
            assert pd[k][n].dtype == torch.float64
            assert np.array_equal(pd[k][n].numpy(), np.asarray(v))


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


@pytest.mark.parametrize("kwargs,call", [
    (dict(jitter_ladder="recompute"), None),
    (dict(precision="double", fold_noise=True, jitter_ladder=False), None),
], ids=["recompute", "fold_noise"])
def test_unported_paths_raise_naming_the_roadmap(kwargs, call):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gp = TorchGP(kernel=torch_kernel("se"), **kwargs)
        call(gp)


def _robust_alpha_pair(data, monkeypatch):
    x, y, _ = data
    y = y.copy()
    y[:4] += 5.0
    jg = JaxGP(kernel=jax_kernel("matern12"), s=1.0, loss="huber")
    tg = TorchGP(kernel=torch_kernel("matern12"), s=1.0, loss="huber")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert tg.robust_status["converged"]
    return tg.A.numpy(), np.asarray(jg.A)


def _ucb_pair(data, monkeypatch):
    import jax

    x, y, _ = data
    U = np.random.default_rng(3).uniform(size=(6, 3))
    bounds = [[-1.0, 1.0]] * 3
    jg = JaxGP(kernel=jax_kernel("se"), s=S, bounds=bounds)
    tg = TorchGP(kernel=torch_kernel("se"), s=S, bounds=bounds)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    # both packages start from the same uniforms
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(U))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.as_tensor(U))
    jp, _ = jg.ucb_optimize(multistart=6, steps=50)
    tp, _ = tg.ucb_optimize(multistart=6, steps=50, generator=torch.Generator())
    return tp.numpy(), np.asarray(jp)


def _zoom_pair(data, monkeypatch):
    from stpy_tpu.opt.lbfgs import minimize_lbfgs as jax_minimize

    x0 = np.array([-1.2, 1.0, 0.3])

    def rosen(lib):
        return lambda v: lib.sum(100 * (v[1:] - v[:-1] ** 2) ** 2
                                 + (1 - v[:-1]) ** 2)

    t = minimize_lbfgs(rosen(torch), torch.as_tensor(x0), max_iter=100)
    j = jax_minimize(rosen(jnp), jnp.asarray(x0), max_iter=100)
    assert t.converged and bool(j.converged)
    return t.x.numpy(), np.asarray(j.x)


@pytest.mark.parametrize("pair", [_robust_alpha_pair, _ucb_pair, _zoom_pair],
                         ids=["robust-loss", "ucb_optimize", "zoom"])
def test_formerly_unported_paths_match_jax(data, pair, monkeypatch):
    # the paths the raise test above named before they were ported: the
    # huber MAP alpha (its L-BFGS converged in both), ucb_optimize from the
    # same starts, and the zoom line search's default L-BFGS
    got, want = pair(data, monkeypatch)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) <= 1e-8


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
