"""Port parity: stpy_tpu_torch/test_functions/benchmarks.py against
stpy_tpu on the CPU, JAX in x64 and torch in float64, the same numpy
inputs from a seed.

Every `BenchmarkFunction` subclass's `eval_noiseless` and `maximum` agree
within 1e-10 relative; `eval` and `initial_guess` are held on the JAX
package's own draws (recovered from its outputs and fed to the port's
draw helpers `benchmarks._normal` / `_uniform`); `optimize`'s γ within
1e-6 at n = 64 on the same noisy data (one restart, from the current
bandwidths in both packages). The data benchmarks and the configs are in
tests/test_torch_port_data_benchmarks.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import test_functions as jtf
from stpy_tpu.embeddings import HermiteEmbedding as JHermite
from stpy_tpu_torch import test_functions as ttf
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.test_functions import benchmarks as tbm

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10
FIT_RTOL = 1e-6

BENCHMARKS = [
    ("CamelbackBenchmark", {}),
    ("QuadraticBenchmark", {"d": 3}),
    ("PolynomialBenchmark", {"d": 3}),
    ("MichalBenchmark", {"d": 3}),
    ("StybTangBenchmark", {"d": 4}),
    ("GeneralizedAdditiveOverlap", {"d": 3}),
    ("Simple1DFunction", {"d": 1}),
    ("MultiRKHS", {}),
    ("CustomBenchmark", {"d": 2}),
]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def pair(name, kw):
    extra = {}
    if name == "CustomBenchmark":
        extra = {"f": lambda X: X[:, :1] ** 2 - X[:, 1:] ** 3}
    return (getattr(jtf, name)(**kw, **extra),
            getattr(ttf, name)(**kw, **extra, **F64))


@pytest.mark.parametrize("name, kw", BENCHMARKS)
def test_eval_noiseless_and_maximum_match_jax(name, kw):
    j, t = pair(name, kw)
    assert t.d == j.d and t.type == j.type
    X = np.random.default_rng(0).uniform(-0.5, 0.5, (50, j.d))
    assert rel(t.eval_noiseless(torch.as_tensor(X)),
               j.eval_noiseless(jnp.asarray(X))) < RTOL
    grid = np.asarray(j.interval(6))
    np.testing.assert_array_equal(t.interval(6), grid)
    if name != "CustomBenchmark":
        want = j.maximum(jnp.asarray(grid))
        got = t.maximum(grid)
        assert (got is None and want is None) or got == pytest.approx(
            want, rel=RTOL)
    assert t.bounds() == j.bounds() and t.bandwidth() == j.bandwidth()


def feed(monkeypatch, name, draws):
    """The port's draw helper `name` returns `draws` in turn."""
    it = iter(draws)
    monkeypatch.setattr(tbm, name, lambda g, shape, dtype: torch.as_tensor(
        np.asarray(next(it)), dtype=dtype).reshape(shape))


def test_eval_and_initial_guess_on_the_jax_draws(monkeypatch):
    j = jtf.StybTangBenchmark(d=2, seed=3)
    t = ttf.StybTangBenchmark(d=2, seed=3, **F64)
    X = np.random.default_rng(1).uniform(-0.5, 0.5, (30, 2))
    yj = np.asarray(j.eval(jnp.asarray(X), sigma=0.2))
    z = (yj - np.asarray(j.eval_noiseless(jnp.asarray(X)))) / 0.2
    feed(monkeypatch, "_normal", [z])
    assert rel(t.eval(X, sigma=0.2), yj) < RTOL
    gj = np.asarray(j.initial_guess(7, adv_inv=True))
    feed(monkeypatch, "_uniform", [(gj + 0.5) / 0.5])
    assert rel(t.initial_guess(7, adv_inv=True), gj) < RTOL


def test_sampled_truths_match_jax_on_the_jax_draws():
    j = jtf.GaussianProcessSample(d=2, gamma=0.3, sigma=0.1, n=8)
    t = ttf.GaussianProcessSample(d=2, gamma=0.3, sigma=0.1, n=8, **F64)
    np.testing.assert_array_equal(t.xtest, j.xtest)
    assert t.values.shape == (64, 1)
    t.values = torch.as_tensor(np.array(j.values))
    X = np.random.default_rng(2).uniform(-0.5, 0.5, (20, 2))
    assert rel(t.eval_noiseless(X), j.eval_noiseless(jnp.asarray(X))) < RTOL
    je, te = JHermite(gamma=0.5, m=6, d=1), THermite(gamma=0.5, m=6, d=1,
                                                     **F64)
    j = jtf.KernelizedSample(d=1, sigma=0.1, embed=je, m=6)
    t = ttf.KernelizedSample(d=1, sigma=0.1, embed=te, m=6, **F64)
    t.set_theta(np.asarray(j.theta))
    j.set_cutoff(4)
    t.set_cutoff(4)
    X = np.linspace(-0.5, 0.5, 11)[:, None]
    assert rel(t.eval_noiseless(X), j.eval_noiseless(jnp.asarray(X))) < RTOL
    j, t = jtf.LinearBenchmark(3, 0.1), ttf.LinearBenchmark(3, 0.1, **F64)
    t.theta = torch.as_tensor(np.array(j.theta))
    X = np.random.default_rng(3).standard_normal((5, 3))
    assert rel(t.eval_noiseless(X), j.eval_noiseless(jnp.asarray(X))) < RTOL


def test_optimize_matches_jax_at_small_n(monkeypatch):
    j = jtf.StybTangBenchmark(d=2, seed=5)
    t = ttf.StybTangBenchmark(d=2, seed=5, **F64)
    X = np.random.default_rng(4).uniform(-0.5, 0.5, (64, 2))
    y = None

    def capture(self, Xe, sigma=None):
        nonlocal y
        y = orig(self, Xe, sigma)
        return y

    orig = jtf.StybTangBenchmark.eval
    monkeypatch.setattr(jtf.StybTangBenchmark, "eval", capture)
    gj = j.optimize(jnp.asarray(X), 0.1, restarts=1)
    z = (np.asarray(y) - np.asarray(j.eval_noiseless(jnp.asarray(X)))) / 0.1
    feed(monkeypatch, "_normal", [z])
    gt = t.optimize(X, 0.1, restarts=1)
    assert gt == pytest.approx(gj, rel=FIT_RTOL)
    assert gt != pytest.approx(0.1)
