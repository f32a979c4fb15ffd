"""Port parity: the HMC-corrected rate bands of
stpy_tpu_torch/approx_inference/sgcp.py (`rate_bands_mcmc`, on the port's
`inference/hmc`) against stpy_tpu's on the CPU.

The JAX package fits a 1-D SGCP (40 events, 12 inducing points, 100 Adam
steps, JAX in x64) and the port carries its state
(`convert.load_sgcp_state`, float64). Fed the JAX package's own draws
(the HMC momenta and acceptance uniforms of 20 steps, regenerated from its
key as it splits it, and the residual normals), the bands and the
acceptance rate agree within 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu_torch.inference import hmc as thmc

from test_torch_port_sgcp import (
    F64, SAMPLER, _XT, carried, feed_normal, rel,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def fitted():
    return carried()


def test_mcmc_bands_match_jax_on_the_same_draws(fitted, monkeypatch):
    j, t = fitted[:2]
    key, steps, theta_dim = jax.random.PRNGKey(7), 20, j.M + 2
    normals, uniforms = [], []
    for k in jax.random.split(key, steps):
        k1, k2 = jax.random.split(k)
        normals.append(jax.random.normal(k1, (theta_dim,), F64))
        uniforms.append(jax.random.uniform(k2, (), F64))
    it_n, it_u = iter(normals), iter(uniforms)
    monkeypatch.setattr(thmc, "_normal",
                        lambda g, like: torch.tensor(np.asarray(next(it_n))))
    monkeypatch.setattr(thmc, "_uniform",
                        lambda g, like: torch.tensor(np.asarray(next(it_u))))
    feed_normal(monkeypatch, [jax.random.normal(
        jax.random.fold_in(key, 1), (12, 32), F64)])
    kw = dict(delta=0.1, samples=12, warmup=8, step_size=0.05,
              leapfrog_steps=5)
    lo_j, hi_j, acc_j = j.rate_bands_mcmc(jnp.asarray(_XT), key=key, **kw)
    lo_t, hi_t, acc_t = t.rate_bands_mcmc(_XT, **kw)
    assert rel(lo_t, lo_j) < SAMPLER and rel(hi_t, hi_j) < SAMPLER
    assert acc_t == pytest.approx(acc_j)
