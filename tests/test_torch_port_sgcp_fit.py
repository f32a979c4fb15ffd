"""Port parity: the Adam fit of stpy_tpu_torch/approx_inference/sgcp.py
(optax's update, written out in the port) against the JAX package's
`optax.adam` scan on the CPU, on the JAX package's own fit-quality case
(tests/test_inference.py): events of λ(x) = 60 σ(3 sin 3x) drawn by its
Poisson process and carried over as numpy, 16 inducing points, 128
quadrature nodes, 600 steps from the same start, JAX in x64 and torch in
float64. The fitted parameters and ELBO agree within 1e-6 relative, and
the port's mean rate meets the JAX package's bar against the truth.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stpy_tpu.domains import BorelSet as JBox
from stpy_tpu.point_processes import PoissonPointProcess

from test_torch_port_sgcp import DET, ITER, _XT, make, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def cox_rate(x):
    return 60.0 * jax.nn.sigmoid(3.0 * jnp.sin(3.0 * x[:, 0]))


@pytest.fixture(scope="module")
def fitted():
    """The JAX package's own fit-quality case (tests/test_inference.py):
    events of λ(x) = 60 σ(3 sin 3x) drawn by its Poisson process, carried
    over as numpy; both packages fit 600 Adam steps from the same start."""
    proc = PoissonPointProcess(d=1, B=60.0, rate=cox_rate)
    obs = np.asarray(proc.sample_discretized(
        jax.random.PRNGKey(3), JBox(1, [[-1.0, 1.0]]), dt=1.0, n=512))
    j, t = make(obs, gamma=0.35, inducing=16, integration=128,
                lam_max_init=60.0)
    ej, et = j.run(steps=600), t.run(steps=600)
    fit = {k: v.clone() for k, v in t.params.items()}
    est = t.mean_rate_points(_XT[2:-2]).numpy()
    return j, t, ej, et, fit, est


def test_adam_fit_matches_jax_and_tracks_the_rate(fitted):
    j, t, ej, et, fit, est = fitted
    assert rel(et, ej) < ITER
    for k in ("m", "L_raw", "log_lam"):
        assert rel(fit[k], j.params[k]) < ITER, k
    assert t.lam_max == pytest.approx(j.lam_max, rel=DET)
    # the JAX package's bar on the same case
    true = np.asarray(cox_rate(jnp.asarray(_XT[2:-2])))
    assert np.abs(est - true).mean() / true.mean() < 0.35
