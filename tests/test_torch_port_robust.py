"""Port parity: the robust losses of stpy_tpu_torch's GaussianProcess
(`loss="huber" | "svr" | "unif"`): the MAP alpha (`_robust_alpha`, L-BFGS
with the zoom line search), `fit_gp` and `fit_predict` on both tiers, the
MAP/Laplace evidence (`log_marginal` → `_log_marginal_map`) and its
γ-derivative, `optimize_params` and `load_fitted_state`, against
stpy_tpu on the CPU.

The same numpy data (48 points in [−1, 1]³, three outliers shifted by +5,
fixed seed) goes through both packages, JAX in x64 and torch in float64,
on an SE kernel (γ = 0.3, s = 0.3), where every loss's L-BFGS converges
within its 500 iterations (on worse-conditioned data the two runs agree
for ~40 iterations and then part at the last bit, as any two L-BFGS runs
do). Tolerances: alpha within 1e-6 relative (svr's smoothed hinge: 1.3e-7
measured), the posterior mean within 1e-8 and the std within 1e-12
relative; the MAP evidence within 1e-9 relative and its γ-derivative
within 1e-6 (huber: 2.5e-8 measured; the inner argmin's last bits).
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
from stpy_tpu_torch.convert import load_fitted_state

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

LOSSES = ("huber", "svr", "unif")
KW = dict(kernel_name="squared_exponential", gamma=0.3, d=3)
S = 0.3
ALPHA_RTOL, MEAN_RTOL, STD_RTOL = 1e-6, 1e-8, 1e-12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (48, 3))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((48, 1))
    y[:3] += 5.0
    return x, y, rng.uniform(-1, 1, (20, 3))


def pair(loss, **kw):
    return (JaxGP(kernel=JaxKernel(**KW), s=S, loss=loss, **kw),
            TorchGP(kernel=TorchKernel(device="cpu", dtype=torch.float64,
                                       **KW), s=S, loss=loss, **kw))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("loss", LOSSES)
def test_robust_fit_predict_matches_jax(data, loss):
    x, y, xt = data
    jg, tg = pair(loss)
    jm, js = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    tm, ts = tg.fit_predict(x, y, xt)
    assert tg.robust_status["converged"]
    assert rel(tg.A.numpy(), jg.A) <= ALPHA_RTOL
    assert rel(tm.numpy(), jm) <= MEAN_RTOL
    assert np.max(np.abs(ts.numpy() - np.asarray(js)) / np.asarray(js)) \
        <= STD_RTOL
    # the MAP alpha is not the squared loss's
    squared = TorchGP(kernel=TorchKernel(device="cpu", dtype=torch.float64,
                                         **KW), s=S)
    squared.fit_gp(x, y)
    assert rel(squared.A.numpy(), jg.A) > 1e-2


def test_robust_double_tier_reads_the_map_alpha_with_a_zero_lo(data):
    x, y, xt = data
    jg, tg = pair("huber", precision="double")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert torch.equal(tg._A_df[:, 1], torch.zeros(48))
    assert rel(tg._A_df.numpy(), jg._A_df) <= ALPHA_RTOL
    tm, ts = tg.mean_std(xt)
    jm, js = jg.mean_std(jnp.asarray(xt))
    assert rel(tm.numpy(), jm) <= MEAN_RTOL
    assert np.max(np.abs(ts.numpy() - np.asarray(js)) / np.asarray(js)) \
        <= STD_RTOL


@pytest.mark.parametrize("loss", LOSSES)
def test_map_evidence_and_its_gamma_derivative_match_jax(data, loss):
    x, y, _ = data
    jg, tg = pair(loss)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    jv, jd = jax.value_and_grad(lambda g: jg.log_marginal(
        jg.kernel_object, {"0": {"gamma": g}}))(jnp.asarray(0.3))
    g = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    tv = tg.log_marginal(tg.kernel_object, {"0": {"gamma": g}})
    (td,) = torch.autograd.grad(tv, g)
    assert abs(float(tv.detach()) - float(jv)) <= 1e-9 * abs(float(jv))
    assert abs(float(td) - float(jd)) <= 1e-6 * abs(float(jd))


def test_robust_optimize_params_fits_the_gaussian_evidence_then_the_map(data):
    # as in the JAX package, optimize_params_general fits the Gaussian
    # evidence whatever the loss; the refit then takes the MAP alpha
    x, y, _ = data
    _, tg = pair("huber")
    tg.fit_gp(x, y)
    tg.optimize_params(type="bandwidth", restarts=2, maxiter=20)
    sq = TorchGP(kernel=TorchKernel(device="cpu", dtype=torch.float64, **KW),
                 s=S)
    sq.fit_gp(x, y)
    sq.optimize_params(type="bandwidth", restarts=2, maxiter=20)
    g_fit = tg.kernel_object.params_dict["0"]["gamma"]
    assert torch.equal(g_fit, sq.kernel_object.params_dict["0"]["gamma"])
    jg = JaxGP(kernel=JaxKernel(**{**KW, "gamma": float(g_fit)}), s=S,
               loss="huber")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    assert rel(tg.A.numpy(), jg.A) <= ALPHA_RTOL


def test_load_fitted_state_serves_the_jax_map_alpha(data):
    x, y, xt = data
    jg, tg = pair("svr")
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    load_fitted_state(tg, np.asarray(jg.x), np.asarray(jg.y),
                      np.asarray(jg.L), np.asarray(jg.A))
    tm, ts = tg.mean_std(xt)
    jm, js = jg.mean_std(jnp.asarray(xt))
    assert rel(tm.numpy(), jm) <= 1e-12
    assert np.max(np.abs(ts.numpy() - np.asarray(js)) / np.asarray(js)) \
        <= STD_RTOL
