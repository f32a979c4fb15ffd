"""Port parity: the rate functions of
stpy_tpu_torch/approx_inference/sgcp.py (`mean_rate_points`,
`rate_bands_exact`, `sample_rate_points`, `rate_bands`) against stpy_tpu's
on the CPU, on the state of a JAX fit (the 1-D model of
tests/test_torch_port_sgcp.py, 100 Adam steps) carried by
`convert.load_sgcp_state`, JAX in x64 and torch in float64. The mean rate
and the exact bands agree within 1e-10 relative; fed the JAX package's
own normals, the sampled rates and bands within 1e-8. The JAX functions
run under `jax.jit`.
"""

import pytest

import jax
import jax.numpy as jnp

from test_torch_port_sgcp import (
    DET, F64, SAMPLER, _XT, carried, feed_normal, rel,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def fitted():
    return carried()


def test_rates_and_exact_bands_match_jax(fitted):
    j, t = fitted[:2]
    xt = jnp.asarray(_XT)
    assert rel(t.mean_rate_points(_XT), jax.jit(j.mean_rate_points)(xt)) \
        < DET
    for a, b in zip(t.rate_bands_exact(_XT, delta=0.1),
                    jax.jit(j.rate_bands_exact)(xt)):
        assert rel(a, b) < DET


def test_sampled_rates_and_bands_match_jax_on_the_same_draws(fitted,
                                                             monkeypatch):
    j, t = fitted[:2]
    xt, key = jnp.asarray(_XT), jax.random.PRNGKey(0)
    feed_normal(monkeypatch, [jax.random.normal(key, (32, 64), F64)] * 2)
    assert rel(t.sample_rate_points(_XT, size=64), jax.jit(
        lambda z, k: j.sample_rate_points(z, size=64, key=k))(xt, key)) \
        < SAMPLER
    for a, b in zip(t.rate_bands(_XT, delta=0.1, samples=64), jax.jit(
            lambda z, k: j.rate_bands(z, samples=64, key=k))(xt, key)):
        assert rel(a, b) < SAMPLER
