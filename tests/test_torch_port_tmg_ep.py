"""Port parity: stpy_tpu_torch/inference/tmg.py against stpy_tpu's on the
CPU.

The sampler is fed the JAX package's own draws: the test regenerates them
from the JAX key exactly as the JAX package makes them
(`jax.random.split` / `normal`) and hands them, in order, to the port's
draw helper (`tmg._normal`). Then the truncated-Gaussian chains agree,
JAX in x64 and torch in float64, within 1e-8 relative over 25 samples
(each an exact-HMC trajectory with its wall bounces). The f32 callers'
float64 trajectories are held in tests/test_torch_port_tmg_f32.py, EP in
tests/test_torch_port_ep.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.inference.tmg import tmg_sample as j_tmg
from stpy_tpu_torch.inference import tmg as ttmg

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
SAMPLER = 1e-8
F64 = jnp.float64


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def feed(monkeypatch, module, name, draws):
    it = iter(draws)

    def draw(*args, **kwargs):
        return torch.tensor(np.asarray(next(it)))

    monkeypatch.setattr(module, name, draw)
    return it


TMG_CASES = {
    # the JAX package's own cases (tests/test_inference.py), and a
    # correlated 3-D Gaussian in a slab cut by a mixed wall
    "orthant": (np.zeros(2), np.eye(2), np.eye(2), np.zeros(2),
                0.5 * np.ones(2)),
    "interval": (np.zeros(1), np.eye(1), np.array([[1.0], [-1.0]]),
                 np.array([-0.5, 1.5]), np.array([1.0])),
    "correlated": (np.array([0.3, -0.2, 0.1]),
                   np.array([[1.0, 0.5, 0.2], [0.5, 1.5, -0.3],
                             [0.2, -0.3, 0.8]]),
                   np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                             [1.0, 1.0, 1.0]]),
                   np.array([0.2, 1.0, 0.5]), np.array([0.1, 0.2, 0.3])),
}


@pytest.mark.parametrize("name", list(TMG_CASES))
def test_tmg_matches_jax_on_the_same_draws(name, monkeypatch):
    mu, Sigma, F, g, x0 = TMG_CASES[name]
    n, sps, key = 25, 1 if name != "correlated" else 2, jax.random.PRNGKey(4)
    d = mu.shape[0]
    draws = [np.asarray(jax.random.normal(k, (d,), F64))
             for k in jax.random.split(key, n * sps)]
    feed(monkeypatch, ttmg, "_normal", draws)
    xj = j_tmg(key, n, jnp.asarray(mu), jnp.asarray(Sigma), jnp.asarray(F),
               jnp.asarray(g), jnp.asarray(x0), steps_per_sample=sps)
    xt = ttmg.tmg_sample(None, n, mu, Sigma, F, g, x0, steps_per_sample=sps,
                         device="cpu", dtype=torch.float64)
    assert rel(xt, xj) < SAMPLER
    assert float(torch.min(t(F) @ xt.T + t(g)[:, None])) >= -1e-9


def test_tmg_bounce_cap_stays_inside_where_the_jax_trajectories_leave(
        monkeypatch):
    """Departure: trajectories long enough to hit the bounce cap
    (max_bounces = 7, T = 40) stop on a wall. From there the JAX package's
    next trajectory leaves the interval when its momentum points out (it
    skips exits closer than 1e-9); the port exits only through a wall, and
    at once through one it sits on moving out, so it reflects. The two
    chains agree within 1e-8 up to the JAX package's first escape (its
    11th draw); all the port's samples stay in [0.5, 1.5]."""
    mu, Sigma, F, g, x0 = TMG_CASES["interval"]
    key = jax.random.PRNGKey(9)
    draws = [np.asarray(jax.random.normal(k, (1,), F64))
             for k in jax.random.split(key, 20)]
    feed(monkeypatch, ttmg, "_normal", draws)
    kw = dict(T=40.0, max_bounces=7)
    xj = np.asarray(j_tmg(key, 20, jnp.asarray(mu), jnp.asarray(Sigma),
                          jnp.asarray(F), jnp.asarray(g), jnp.asarray(x0),
                          **kw))[:, 0]
    xt = ttmg.tmg_sample(None, 20, mu, Sigma, F, g, x0, device="cpu",
                         dtype=torch.float64, **kw)[:, 0]
    first_out = int(np.argmax((xj < 0.5 - 1e-9) | (xj > 1.5 + 1e-9)))
    assert first_out == 10
    assert rel(xt[:first_out], xj[:first_out]) < SAMPLER
    assert float(xt.min()) >= 0.5 - 1e-12 and float(xt.max()) <= 1.5 + 1e-12
