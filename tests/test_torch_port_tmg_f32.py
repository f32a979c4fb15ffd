"""Port parity and departure: stpy_tpu_torch/inference/tmg.py for an f32
caller against stpy_tpu's f32 on the CPU, and the samplers' default
device.

The port runs the whitening and the trajectories in float64 whatever the
caller's dtype. The JAX package's f32 trajectories leave the 32-dimensional
positive orthant (ROADMAP Queue 3); the port's f32 samples stay in and
their marginal mean is the truncated normal's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.inference.tmg import tmg_sample as j_tmg
from stpy_tpu_torch.approx_inference import ExpectedPropagationQuadratic as TEP
from stpy_tpu_torch.inference import tmg as ttmg

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_f32_trajectories_stay_inside_where_the_jax_f32_ones_leave():
    """Departure: the port runs the trajectories in float64 for an f32
    caller. The JAX package's f32 trajectories bounce twice off the wall
    they have just hit (its re-hit phase rounds above the 1e-9 guard) and
    leave the positive orthant in d = 32; the port's f32 samples stay in
    and their mean is the truncated normal's √(2/π)."""
    d, n, key = 32, 150, jax.random.PRNGKey(4)
    f32 = jnp.float32
    xj = j_tmg(key, n, jnp.zeros(d, f32), jnp.eye(d, dtype=f32),
               jnp.eye(d, dtype=f32), jnp.zeros(d, f32),
               0.5 * jnp.ones(d, f32))
    assert xj.dtype == f32 and float(jnp.min(xj)) < -0.1
    gen = torch.Generator().manual_seed(0)
    xt = ttmg.tmg_sample(gen, n, np.zeros(d), np.eye(d), np.eye(d),
                         np.zeros(d), 0.5 * np.ones(d), device="cpu")
    assert xt.dtype == torch.float32 and float(xt.min()) >= 0.0
    assert abs(float(xt.mean()) - np.sqrt(2 / np.pi)) < 0.05


def test_samplers_default_to_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TEP(np.zeros(2), np.eye(2), lambda z, d: z, [0.0]),
                 lambda: ttmg.tmg_sample(None, 1, np.zeros(1), np.eye(1),
                                         np.eye(1), np.zeros(1),
                                         np.ones(1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    gen = torch.Generator().manual_seed(0)
    xs = ttmg.tmg_sample(gen, 200, np.zeros(2), np.eye(2), np.eye(2),
                         np.zeros(2), 0.5 * np.ones(2), device="cpu")
    assert xs.device.type == "cpu" and xs.dtype == torch.float32
    assert float(xs.min()) >= 0.0
