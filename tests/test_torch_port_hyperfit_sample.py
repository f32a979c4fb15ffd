"""Port parity: `GaussianProcess.sample` and `log_probability` of
stpy_tpu_torch against stpy_tpu on the CPU: draws as the mean plus the
factor times the generator's normals, the prior draw of an unfitted GP,
the f32 model's float64 covariance, the ladder's failure, and
`log_probability` within 1e-10 (tests/test_torch_port_hyperfit.py's
EVIDENCE_RTOL).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.linalg import safe_cholesky as jax_safe_cholesky
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.linalg import safe_cholesky

from test_torch_port_hyperfit import MEAN_RTOL, close, data, pair
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


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
