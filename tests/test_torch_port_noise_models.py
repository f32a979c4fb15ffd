"""Port parity: stpy_tpu_torch/probability/noise_models.py against
stpy_tpu/probability/noise_models.py on the CPU.

Each noise model is fed the JAX package's own draws: the test regenerates
them from the JAX key exactly as the JAX package makes them
(`jax.random.split` / `normal` / `laplace` / `uniform` / `gumbel` /
`rademacher` / `bernoulli` / `poisson`) and hands them to the port's draw
helpers (`noise_models._normal`, `_laplace`, …). Then every model's
observations and log-likelihood agree, JAX in x64 and torch in float64,
within 1e-10 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import probability as jpb
from stpy_tpu_torch import probability as tpb
from stpy_tpu_torch.probability import noise_models as tnm

from test_torch_port_tmg_ep import DET, F64, feed, rel, t
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def _normal(k, n):
    return jax.random.normal(k, (n, 1), F64)


NOISE = {
    "gaussian": (lambda m, kw: m.GaussianNoise(sigma=0.5, **kw),
                 {"_normal": lambda k, n: [_normal(k, n)]}),
    "huber": (lambda m, kw: m.HuberContaminatedNoise(sigma=0.3, **kw),
              {"_normal": lambda k, n: [_normal(jax.random.split(k)[0], n)],
               "_laplace": lambda k, n: [jax.random.laplace(
                   jax.random.split(k)[1], (n, 1), F64)]}),
    "bounded": (lambda m, kw: m.BoundedNoise(-0.2, 0.4, **kw),
                {"_uniform": lambda k, n: [jax.random.uniform(k, (n, 1), F64)]}),
    "misspecified": (lambda m, kw: m.MisspecifiedGaussianNoise(
        sigma=1.0, actual_sigma=0.2, **kw),
        {"_normal": lambda k, n: [_normal(k, n)]}),
    "laplace": (lambda m, kw: m.LaplaceNoise(b=0.3, **kw),
                {"_laplace": lambda k, n: [jax.random.laplace(k, (n, 1), F64)]}),
    "gumbel": (lambda m, kw: m.GumbelNoise(beta=0.4, mu=0.1, **kw),
               {"_gumbel": lambda k, n: [jax.random.gumbel(k, (n, 1), F64)]}),
    "two_sided_weibull": (
        lambda m, kw: m.TwoSidedWeibullNoise(k=1.5, lam=0.7, **kw),
        {"_uniform": lambda k, n: [jax.random.uniform(
            jax.random.split(k)[0], (n, 1), F64)],
         "_rademacher": lambda k, n: [jax.random.rademacher(
             jax.random.split(k)[1], (n, 1)).astype(F64)]}),
    "log_weibull": (lambda m, kw: m.LogWeibullNoise(k=2.0, lam=0.5, **kw),
                    {"_uniform": lambda k, n: [jax.random.uniform(
                        k, (n, 1), F64)]}),
    "bernoulli": (lambda m, kw: m.BernoulliNoise(**kw), None),
    "poisson": (lambda m, kw: m.PoissonNoise(
        lam=lambda x: 2.0 + x[:, 0] ** 2, **kw), None),
}


@pytest.mark.parametrize("name", list(NOISE))
def test_noise_model_matches_jax_on_the_same_draws(name, monkeypatch):
    make, helpers = NOISE[name]
    n, key = 40, jax.random.PRNGKey(0)
    rng = np.random.default_rng(6)
    xs, theta = rng.uniform(-1, 1, (n, 2)), np.array([0.4, -0.7])
    j = make(jpb, {})
    m = make(tpb, {"device": "cpu", "dtype": torch.float64})
    if name == "bernoulli":
        p = jax.nn.sigmoid(jnp.asarray(xs) @ jnp.asarray(theta)[:, None])
        feed(monkeypatch, tnm, "_bernoulli", [jax.random.bernoulli(key, p)])
    elif name == "poisson":
        rate = 2.0 + jnp.asarray(xs)[:, 0] ** 2
        feed(monkeypatch, tnm, "_poisson",
             [np.asarray(jax.random.poisson(key, rate), float)])
    else:
        for helper, draws in helpers.items():
            feed(monkeypatch, tnm, helper, draws(key, n))
    yj = j.sample(key, jnp.asarray(xs), jnp.asarray(theta))
    yt = m.sample(None, xs, theta)
    assert rel(yt, yj) < DET
    assert str(m) == str(j) and m.convex == j.convex
    if name in ("bernoulli",) or hasattr(m, "sigma") or name in (
            "laplace", "gumbel", "two_sided_weibull"):
        lj = j.joint_log_likelihood(yj, jnp.asarray(xs), jnp.asarray(theta))
        lt = m.joint_log_likelihood(yt, t(xs), t(theta))
        assert rel(lt, lj) < DET
    if name not in ("bernoulli", "poisson"):
        empty = m.log_likelihood(torch.zeros((0, 1), dtype=torch.float64),
                                 t(xs[:0]), t(theta))
        assert float(empty) == 0.0


def test_noise_models_default_to_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.GaussianNoise(0.1)
    gen = torch.Generator().manual_seed(0)
    y = tpb.LaplaceNoise(0.3, device="cpu").sample(gen, np.ones((500, 1)),
                                                   np.zeros(1))
    assert y.device.type == "cpu" and y.dtype == torch.float32
    assert abs(float(torch.var(y)) - 2 * 0.3**2) < 0.05
    for nm in (tpb.GumbelNoise(0.4, device="cpu"),
               tpb.TwoSidedWeibullNoise(device="cpu"),
               tpb.BoundedNoise(-0.2, 0.4, device="cpu"),
               tpb.HuberContaminatedNoise(0.3, device="cpu"),
               tpb.PoissonNoise(lambda x: 2.0 + 0 * x[:, 0], device="cpu")):
        ys = nm.sample(gen, np.ones((300, 1)), np.zeros(1))
        assert ys.shape == (300, 1) and bool(torch.isfinite(ys).all())
