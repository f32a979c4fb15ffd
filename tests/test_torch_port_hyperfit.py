"""Port parity: the exact GP's evidence hyperfit and posterior sampling of
stpy_tpu_torch against stpy_tpu on the CPU.

The same numpy inputs go through both packages, JAX in x64 and torch in
float64; on the CPU the port's Gram Functions run their plain versions in
the forward and the JAX package's closed-form backward. Tolerances: the
Gram gradients against JAX's custom VJPs within 1e-12 of their largest
entry; the evidence and its gradient within 1e-10; fitted parameters within
1e-8 relative, with equal iteration counts; posterior means after the refit
within 1e-8; `log_probability` within 1e-10; config 1 at n = 128 within
1e-6.
"""

import pickle

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.linalg import safe_cholesky as jax_safe_cholesky
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu.ops import pallas_gram as jg
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.linalg import safe_cholesky
from stpy_tpu_torch.ops import launch_counts
from stpy_tpu_torch.ops.gram import _Gram, gram_matern, gram_se
from stpy_tpu_torch.ops.gram_l1 import _GramL1, gram_laplace

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

GRAD_RTOL, EVIDENCE_RTOL, FIT_RTOL, MEAN_RTOL = 1e-12, 1e-10, 1e-8, 1e-8
FAMILIES = [("se", 1.5), ("matern", 0.5), ("matern", 1.5), ("matern", 2.5)]


def points(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, d)), rng.uniform(-1, 1, (m, d))


def data(n=96, d=1, seed=2, noise=0.05):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    y = np.sin(4 * x[:, :1]) + noise * rng.standard_normal((n, 1))
    return x, y


def close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    return float(np.max(np.abs(got - want))) <= rtol * scale


def leaf(v):
    return torch.tensor(np.asarray(v, np.float64), requires_grad=True)


# -- the Gram Functions ----------------------------------------------------------

@pytest.mark.parametrize("ard", [False, True], ids=["scalar", "ard"])
@pytest.mark.parametrize("family,nu", FAMILIES)
def test_gram_function_gradient_matches_the_jax_vjp(family, nu, ard):
    a, b = points(7, 5, 3, seed=1)
    gamma = np.array([0.6, 0.9, 1.3]) if ard else np.array(0.8)
    kappa = np.array(1.4)
    gbar = np.random.default_rng(3).standard_normal((7, 5))
    _, vjp = jax.vjp(lambda x, y, g, k: jg._gram(x, y, g, k, family, nu),
                     *(jnp.asarray(v) for v in (a, b, gamma, kappa)))
    want = vjp(jnp.asarray(gbar))
    ts = [leaf(v) for v in (a, b, gamma, kappa)]
    fn = gram_se if family == "se" else (
        lambda x, y, g, k: gram_matern(x, y, g, k, nu=nu))
    K = fn(*ts)
    assert close(K, jg._gram(*(jnp.asarray(v) for v in (a, b, gamma, kappa)),
                             family, nu), 1e-14)
    K.backward(torch.as_tensor(gbar))
    for t, w in zip(ts, want):
        assert close(t.grad, w, GRAD_RTOL)


def test_laplace_function_gradient_matches_the_jax_vjp():
    a, b = points(7, 5, 3, seed=4)
    gbar = np.random.default_rng(5).standard_normal((7, 5))
    args = (a, b, np.array(0.9), np.array(1.2))
    _, vjp = jax.vjp(jg._gram_l1, *(jnp.asarray(v) for v in args))
    want = vjp(jnp.asarray(gbar))
    ts = [leaf(v) for v in args]
    gram_laplace(*ts).backward(torch.as_tensor(gbar))
    for t, w in zip(ts, want):
        assert close(t.grad, w, GRAD_RTOL)


@pytest.mark.parametrize("family,nu", FAMILIES + [("laplace", None)])
def test_gram_functions_pass_gradcheck_and_gradgradcheck(family, nu):
    a, b = points(5, 4, 3, seed=6)
    x, y, k = leaf(a), leaf(b), leaf(1.3)
    if family == "laplace":
        def fn(x, y, k, ig):
            return _GramL1.apply(x, y, ig, k)
        args = (x, y, k, leaf(0.7))
    else:
        def fn(x, y, k):
            return _Gram.apply(x, y, k, family, nu)
        args = (x, y, k)
    assert gradcheck(fn, args)
    assert gradgradcheck(fn, args)


def test_gram_without_a_gradient_skips_the_function():
    a, b = points(5, 4, 2)
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    K = gram_se(x, y, torch.tensor(0.7, dtype=torch.float64))
    assert K.grad_fn is None
    K = gram_se(x, y, leaf(0.7))
    assert type(K.grad_fn).__name__ == "_GramBackward"
    with torch.no_grad():
        assert gram_laplace(x, y, leaf(0.7)).grad_fn is None


# -- the evidence ------------------------------------------------------------------

CASES = {
    "se": dict(kernel_name="squared_exponential", gamma=0.6, d=1),
    "matern32": dict(kernel_name="matern", gamma=0.7, nu=1.5, d=1),
    "laplace": dict(kernel_name="laplace", gamma=1.4, d=1),
    "ard": dict(kernel_name="ard", ard_gamma=[0.5, 0.8, 1.2], d=3),
}


def pair(case, x, y, s=0.1, **kw):
    """A JAX and a port GP of kernel `case`, fitted to the same data."""
    jk = JaxKernel(**CASES[case])
    tk = TorchKernel(**CASES[case], device="cpu", dtype=torch.float64)
    jgp = JaxGP(kernel=jk, s=s, **kw)
    jgp.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tgp = TorchGP(kernel=tk, s=s, **kw)
    tgp.fit_gp(x, y)
    return jgp, tgp


@pytest.mark.parametrize("case", list(CASES))
def test_evidence_and_its_gradient_match_jax(case):
    x, y = data(48, CASES[case]["d"])
    jgp, tgp = pair(case, x, y)
    var = "ard_gamma" if case == "ard" else "gamma"
    g0 = np.asarray(CASES[case].get(var, CASES[case].get("ard_gamma")))

    def jax_f(g, s):
        return jgp.log_marginal_params(jgp.kernel_object, {"0": {var: g}}, s)

    want = jax.value_and_grad(jax_f, argnums=(0, 1))(jnp.asarray(g0),
                                                      jnp.asarray(0.1))
    g, s = leaf(g0), leaf(0.1)
    f = tgp.log_marginal_params(tgp.kernel_object, {"0": {var: g}}, s)
    f.backward()
    assert float(f.detach()) == pytest.approx(float(want[0]),
                                              rel=EVIDENCE_RTOL)
    assert close(g.grad, want[1][0], EVIDENCE_RTOL)
    assert float(s.grad) == pytest.approx(float(want[1][1]), rel=EVIDENCE_RTOL)
    assert float(tgp.log_marginal(tgp.kernel_object, {})) == pytest.approx(
        float(jgp.log_marginal(jgp.kernel_object, {})), rel=EVIDENCE_RTOL)


# -- fits --------------------------------------------------------------------------

# Where the last step of a fit is decided at the evidence's rounding floor
# (an Armijo test between values that differ in their last bits), the two
# packages may take or refuse that step: XLA:CPU in the tests compiles
# without FMA, and torch's CPU kernels round differently. The fitted
# parameters then differ by that last step, within LAST_STEP_RTOL, with
# the same iteration count.
LAST_STEP_RTOL = 1e-6
FITS = {
    # case, type, extra optimize_params arguments, the route it takes,
    # the tolerance of the fitted parameters
    "bandwidth": ("se", "bandwidth", {}, "newton", FIT_RTOL),
    "bandwidth+noise": ("se", "bandwidth+noise", {}, "newton", FIT_RTOL),
    "ard-bandwidth": ("ard", "bandwidth", {}, "batched", FIT_RTOL),
    "laplace-bandwidth": ("laplace", "bandwidth", {}, "newton", FIT_RTOL),
    "kappa": ("matern32", "kappa", {}, "newton", LAST_STEP_RTOL),
    "lasso": ("se", "bandwidth", dict(regularizer=("lasso", 0.5)), "batched",
              LAST_STEP_RTOL),
    "spectral_norm": ("ard", "bandwidth+noise",
                      dict(regularizer=("spectral_norm", 0.1)), "batched",
                      LAST_STEP_RTOL),
}


def params_of(gp, case):
    p = gp.kernel_object.params_dict["0"]
    out = [np.asarray(p["ard_gamma" if case == "ard" else "gamma"]),
           np.asarray(p["kappa"]), np.asarray(float(gp.s))]
    return np.concatenate([np.ravel(v) for v in out])


@pytest.mark.parametrize("name", list(FITS))
def test_fit_matches_jax(name):
    case, kind, extra, route, rtol = FITS[name]
    x, y = data(96, CASES[case]["d"])
    jgp, tgp = pair(case, x, y, s=0.3)
    jgp.optimize_params(type=kind, restarts=1, maxiter=40, **extra)
    tgp.optimize_params(type=kind, restarts=1, maxiter=40, **extra)
    want, got = params_of(jgp, case), params_of(tgp, case)
    assert np.max(np.abs(got - want) / np.abs(want)) <= rtol
    assert tgp.hyperopt_metrics["route"] == route
    assert list(tgp.hyperopt_metrics["iterations"]) == list(
        jgp.hyperopt_metrics["iterations"])
    assert list(tgp.hyperopt_metrics["converged"]) == list(
        jgp.hyperopt_metrics["converged"])
    xt = np.linspace(-1, 1, 40 * CASES[case]["d"]).reshape(40, -1)
    assert close(tgp.mean(xt), jgp.mean(jnp.asarray(xt)), max(rtol, MEAN_RTOL))


def test_bisection_fit_matches_jax():
    """60 golden-section steps: the last brackets' comparisons are at the
    evidence's rounding floor, so the packages agree to LAST_STEP_RTOL."""
    x, y = data(64)
    jgp, tgp = pair("se", x, y, s=0.2)
    for gp in (jgp, tgp):
        gp.optimize_params(type="bandwidth", optimizer="bisection",
                           bounds=(0.05, 3.0))
    want = float(jgp.kernel_object.params_dict["0"]["gamma"])
    assert float(tgp.kernel_object.params_dict["0"]["gamma"]) == pytest.approx(
        want, rel=LAST_STEP_RTOL)


def test_restarts_from_a_callable_init_match_jax_and_save_loads(tmp_path):
    """A callable init gives every restart the same start in both packages,
    so the restarts' values and iterations match too; `save` pickles the
    best point and `load_params` reads it back."""
    x, y = data(64)
    jgp, tgp = pair("se", x, y, s=0.2)
    kw = dict(type="bandwidth", restarts=3, maxiter=40,
              init_func=lambda size: np.full(size, 0.45))
    jgp.optimize_params(**kw)
    path = tmp_path / "fit.np"
    tgp.optimize_params(save=True, save_name=str(path), **kw)
    assert np.allclose(tgp.hyperopt_metrics["values"],
                       jgp.hyperopt_metrics["values"], rtol=1e-10, atol=0)
    saved = tgp.load_params(str(path))
    assert saved["repeats"] == 3 and saved["param_names"] == {"0": ["gamma"]}
    assert float(np.exp(saved["params"][0])) == pytest.approx(
        float(tgp.kernel_object.params_dict["0"]["gamma"]), rel=1e-14)
    with open(path, "rb") as f:
        assert pickle.load(f)["evidence"] == pytest.approx(
            float(tgp.log_marginal(tgp.kernel_object, {})), rel=1e-12)


def test_random_restarts_come_from_the_seeded_generator():
    x, y = data(48)
    fits = []
    for _ in range(2):
        gp = TorchGP(gamma=1.0, s=0.2, d=1, device="cpu", dtype=torch.float64)
        gp.fit_gp(x, y)
        gp.optimize_params(type="bandwidth", restarts=3, maxiter=40)
        fits.append(gp.hyperopt_metrics["values"])
    assert np.array_equal(fits[0], fits[1]) and len(fits[0]) == 3


def test_double_tier_fits_on_the_single_tier_evidence_as_jax():
    x, y = data(64)
    jgp, tgp = pair("se", x, y, s=0.2, precision="double")
    for gp in (jgp, tgp):
        gp.optimize_params(type="bandwidth", restarts=1, maxiter=40)
    want = float(jgp.kernel_object.params_dict["0"]["gamma"])
    assert float(tgp.kernel_object.params_dict["0"]["gamma"]) == pytest.approx(
        want, rel=FIT_RTOL)
    assert tgp._A_df is not None   # the refit is the double tier's


def test_config1_end_to_end_at_n128_matches_jax():
    """benchmarks/run_all.py config 1 cut to n = 128: the same data recipe,
    GaussianProcess(gamma=1.0, s=0.05, d=1), 8 restarts of 40 iterations.
    The random restarts differ (two generators); all reach one optimum."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (128, 1))
    y = np.sin(4 * x) + 0.05 * rng.standard_normal((128, 1))
    jgp = JaxGP(gamma=1.0, s=0.05, d=1)
    jgp.fit_gp(jnp.asarray(x), jnp.asarray(y))
    jgp.optimize_params(type="bandwidth", restarts=8, maxiter=40)
    tgp = TorchGP(gamma=1.0, s=0.05, d=1, device="cpu", dtype=torch.float64)
    tgp.fit_gp(x, y)
    before = launch_counts()
    tgp.optimize_params(type="bandwidth", restarts=8, maxiter=40)
    assert launch_counts() == before   # CPU tensors launch nothing
    want = float(jgp.kernel_object.params_dict["0"]["gamma"])
    assert float(tgp.kernel_object.params_dict["0"]["gamma"]) == pytest.approx(
        want, rel=1e-6)
    assert tgp.hyperopt_metrics["converged"].all()


# -- sampling and log probability ---------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    x, y = data(64)
    return pair("se", x, y, s=0.1), np.linspace(-1.2, 1.2, 30)[:, None]


def test_sample_is_mean_plus_factor_times_the_generators_normals(fitted):
    (jgp, tgp), xt = fitted
    mu_j, cov_j = jgp.mean_std(jnp.asarray(xt), full=True)
    L_j = jax_safe_cholesky(cov_j, jitter=1e-8).L
    mu, cov = tgp.mean_std(xt, full=True)
    L = safe_cholesky(cov.clone(), jitter=1e-8).L
    assert close(mu, mu_j, MEAN_RTOL)
    # the posterior covariance is singular to rounding (eigenvalues ~1e-15
    # below the jitter), so the factors agree through what they factor
    assert close(cov, cov_j, 1e-12)
    assert close(L @ L.T, L_j @ L_j.T, 1e-12)
    draws = tgp.sample(xt, size=5, generator=torch.Generator().manual_seed(7))
    z = torch.randn((30, 5), generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    assert torch.equal(draws, mu + L @ z)


def test_prior_sample_of_an_unfitted_gp():
    gp = TorchGP(gamma=0.5, d=1, device="cpu", dtype=torch.float64)
    xt = np.linspace(-1, 1, 12)[:, None]
    draws = gp.sample(xt, size=3, generator=torch.Generator().manual_seed(1))
    L = safe_cholesky(gp.kernel_object.gram(xt), jitter=1e-8).L
    z = torch.randn((12, 3), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    assert torch.equal(draws, L @ z)


def test_float32_sample_factors_a_float64_covariance():
    """On config 1's data (n = 1024) at its fitted γ, a float32 model's f32
    posterior covariance at 256 points of [−1, 1] is indefinite past the
    jitter ladder; `sample` factors `_moments64`'s instead: k** and K* in
    float64 (the df Gram) against the model's f32 factor and alpha, which
    the default ladder factors with a jitter under 1e-2 of the mean
    variance. The draws are that mean + L z for the generator's f32
    normals, returned in f32."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1024, 1))
    y = np.sin(4 * x) + 0.05 * rng.standard_normal((1024, 1))
    gp = TorchGP(gamma=0.5141, s=0.05, d=1, device="cpu")
    gp.fit_gp(x, y)
    xt = torch.linspace(-1, 1, 256)[:, None]
    # sample's default jitter, 1e-8 of the mean variance, up to 1e-2
    assert not bool(safe_cholesky(gp.mean_std(xt, full=True)[1],
                                  jitter=1e-8).ok)
    mu, cov = gp._moments64(xt)
    assert mu.dtype == cov.dtype == torch.float64
    # the same formula on the plain float64 Gram
    g64 = TorchKernel(gamma=0.5141, d=1, device="cpu", dtype=torch.float64)
    Ks = g64.eval_params({}, xt.double(), gp.x.double())
    V = torch.linalg.solve_triangular(gp.L.double(), Ks.T, upper=False)
    assert close(mu, Ks @ gp.A.double(), 1e-12)
    Kss = g64.eval_params({}, xt.double(), xt.double())
    # to float64's rounding of k** − VᵀV, whose terms are ~κ = 1
    assert float((cov - (Kss - V.T @ V)).abs().max()) <= 1e-12
    res = safe_cholesky(cov.clone(), jitter=1e-8)
    assert bool(res.ok)
    assert float(res.jitter) <= 1e-2 * float(cov.diagonal().mean())
    draws = gp.sample(xt, size=3, generator=torch.Generator().manual_seed(5))
    z = torch.randn((256, 3), generator=torch.Generator().manual_seed(5))
    assert draws.dtype == torch.float32
    assert torch.equal(draws, (mu + res.L @ z.double()).float())


def test_sample_raises_where_the_ladder_fails():
    """A covariance no jitter of the ladder makes positive definite (here a
    prior of negative amplitude) raises instead of giving NaN draws."""
    gp = TorchGP(gamma=0.5, kappa=-1.0, d=1, device="cpu",
                 dtype=torch.float64)
    with pytest.raises(RuntimeError, match="not positive definite"):
        gp.sample(np.linspace(-1, 1, 8)[:, None])


def test_log_probability_matches_jax(fitted):
    """At a few spread points, where the posterior covariance is well
    conditioned (at the 30 points above it is singular to rounding, and
    the density depends on the jitter)."""
    (jgp, tgp), _ = fitted
    xt = np.linspace(-1.1, 1.1, 6)[:, None]
    draw = tgp.sample(xt, generator=torch.Generator().manual_seed(3))
    want = jgp.log_probability(jnp.asarray(xt), jnp.asarray(draw.numpy()))
    assert tgp.log_probability(xt, draw) == pytest.approx(want, rel=1e-10)


def test_float32_model_fits_on_a_float64_evidence():
    """The evidence of a float32 model is factored in float64 (its Gram
    promoted once formed): the value is float64, and config 1's recipe at
    n = 128 fits γ as the float64 model does, to the f32 Gram's rounding."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (128, 1))
    y = np.sin(4 * x) + 0.05 * rng.standard_normal((128, 1))
    fits = {}
    for dt in (torch.float32, torch.float64):
        gp = TorchGP(gamma=1.0, s=0.05, d=1, device="cpu", dtype=dt)
        gp.fit_gp(x, y)
        assert gp.log_marginal(gp.kernel_object, {}).dtype == torch.float64
        gp.optimize_params(type="bandwidth", restarts=2, maxiter=40)
        assert gp.kernel_object.params_dict["0"]["gamma"].dtype == torch.float64
        fits[dt] = float(gp.kernel_object.params_dict["0"]["gamma"])
    assert fits[torch.float32] == pytest.approx(fits[torch.float64], rel=1e-3)
