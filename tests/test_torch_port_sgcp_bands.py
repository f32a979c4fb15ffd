"""Port parity: the linear-response rate bands of
stpy_tpu_torch/approx_inference/sgcp.py (`rate_bands_linear_response`)
against stpy_tpu's on the CPU.

The JAX package fits a 1-D SGCP (40 events, 12 inducing points, 100 Adam
steps, JAX in x64) and the port carries its state
(`convert.load_sgcp_state`, float64). The linear-response bands (2 Newton
steps on the joint optimum) agree within 1e-6 relative. The HMC-corrected
bands are in tests/test_torch_port_sgcp_mcmc.py.
"""

import pytest

import jax
import jax.numpy as jnp

from test_torch_port_sgcp import ITER, _XT, carried, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


@pytest.fixture(scope="module")
def fitted():
    return carried()


def test_linear_response_bands_match_jax(fitted):
    """The JAX method is traced whole under one `jax.jit` (its eager
    Hessian alone takes 10 s on the CPU); its bands are the eager
    method's within 4e-14."""
    j, t = fitted[:2]
    jj = jax.jit(lambda x: j.rate_bands_linear_response(
        x, delta=0.1, newton_steps=2))
    for a, b in zip(t.rate_bands_linear_response(_XT, delta=0.1,
                                                 newton_steps=2),
                    jj(jnp.asarray(_XT))):
        assert rel(a, b) < ITER
