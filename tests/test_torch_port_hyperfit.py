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

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.models import GaussianProcess as JaxGP
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.ops import launch_counts

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
