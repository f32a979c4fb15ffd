"""Port parity: stpy_tpu_torch's OnlineGP against stpy_tpu's on the CPU,
step by step, and against the batch GaussianProcess; and
`convert.load_online_state`.

The same numpy points (fixed seed) are fed one at a time to both
packages, JAX in x64 and torch in float64. Tolerances: the factor, alpha
and the posterior after every add within 1e-12 relative of the JAX
package's; against the port's batch GaussianProcess on the same points
(its own jitter ladder's first step on the diagonal, 1e-12 of the mean
diagonal), the mean within 1e-8 relative and the std within 1e-6. The
buffers' `data_ptr()` never change across adds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.models.online_gp import OnlineGP as JaxOnlineGP
from stpy_tpu_torch.convert import load_online_state
from stpy_tpu_torch.models import GaussianProcess as TorchGP
from stpy_tpu_torch.models import OnlineGP

from test_torch_port_gram import jax_kernel, torch_kernel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

CAP, S = 32, 0.1


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (24, 3))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((24, 1))
    return x, y, rng.uniform(-1, 1, (10, 3))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def buffers(og):
    return [b.data_ptr() for b in (og.x_buf, og.y_buf, og.L, og.alpha)]


@pytest.mark.parametrize("case", ["se", "se+matern32"])
def test_online_gp_matches_jax_step_by_step(data, case):
    x, y, xt = data
    jo = JaxOnlineGP(jax_kernel(case), s=S, capacity=CAP, d=3)
    to = OnlineGP(torch_kernel(case), s=S, capacity=CAP, d=3)
    ptrs = buffers(to)
    for i in range(x.shape[0]):
        jo.add_data_point(jnp.asarray(x[i]), jnp.asarray(y[i]))
        to.add_data_point(x[i], y[i])
        assert to.count == jo.count == i + 1
        assert rel(to.L.numpy(), jo.L) <= 1e-12
        assert rel(to.alpha.numpy(), jo.alpha) <= 1e-12
        if i in (0, 5, x.shape[0] - 1):
            (tm, ts), (jm, js) = to.mean_std(xt), jo.mean_std(jnp.asarray(xt))
            assert rel(tm.numpy(), jm) <= 1e-12 and rel(ts.numpy(), js) <= 1e-12
    assert buffers(to) == ptrs
    assert torch.equal(to.x, torch.as_tensor(x)) and to.y.shape == (24, 1)
    assert torch.equal(to.L[24:, 24:], torch.eye(CAP - 24))


def test_online_gp_matches_the_batch_gp(data):
    x, y, xt = data
    to = OnlineGP(torch_kernel("se"), s=S, capacity=CAP, d=3)
    to.fit_gp(x, y)
    gp = TorchGP(kernel=torch_kernel("se"), s=S)
    gp.fit_gp(x, y)
    (tm, ts), (gm, gs) = to.mean_std(xt), gp.mean_std(xt)
    assert rel(tm.numpy(), gm.numpy()) <= 1e-8
    assert np.max(np.abs(ts.numpy() - gs.numpy()) / gs.numpy()) <= 1e-6
    assert rel(to.ucb(xt).numpy(), (gm + 2 * gs).numpy()) <= 1e-6
    assert rel(to.lcb(xt).numpy(), (gm - 2 * gs).numpy()) <= 1e-6
    assert rel(to.mean(xt).numpy(), gm.numpy()) <= 1e-8


def test_capacity_is_enforced(data):
    x, y, _ = data
    to = OnlineGP(torch_kernel("se"), s=S, capacity=2, d=3)
    to.fit_gp(x[:2], y[:2])
    with pytest.raises(AssertionError, match="capacity"):
        to.add_data_point(x[2], y[2])


def test_load_online_state_serves_the_jax_state(data):
    x, y, xt = data
    jo = JaxOnlineGP(jax_kernel("se+matern32"), s=S, capacity=CAP, d=3)
    jo.fit_gp(jnp.asarray(x[:10]), jnp.asarray(y[:10]))
    to = OnlineGP(torch_kernel("se+matern32"), s=S, capacity=CAP, d=3)
    ptrs = buffers(to)
    load_online_state(to, np.asarray(jo.x_buf), np.asarray(jo.y_buf),
                      np.asarray(jo.L), np.asarray(jo.alpha), jo.count)
    assert buffers(to) == ptrs and to.count == 10
    (tm, ts), (jm, js) = to.mean_std(xt), jo.mean_std(jnp.asarray(xt))
    assert rel(tm.numpy(), jm) <= 1e-12 and rel(ts.numpy(), js) <= 1e-12
    # and the loop goes on from it as the JAX one does
    jo.add_data_point(jnp.asarray(x[10]), jnp.asarray(y[10]))
    to.add_data_point(x[10], y[10])
    assert rel(to.alpha.numpy(), jo.alpha) <= 1e-12
