"""Port parity: stpy_tpu_torch/approx_inference/expected_propagation.py
against stpy_tpu's on the CPU: EP's posterior after 20 sweeps within 1e-10
relative, JAX in x64 and torch in float64, on Gaussian sites (where it is
the conjugate posterior, the JAX package's own case in
tests/test_aux_components.py) and on logistic sites.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.approx_inference import ExpectedPropagationQuadratic as JEP
from stpy_tpu_torch.approx_inference import ExpectedPropagationQuadratic as TEP

from test_torch_port_tmg_ep import DET, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def ep_pair(site, n=6, d=2):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, d))
    y = list(rng.uniform(-0.5, 0.5, n))
    mu0, S0 = np.array([0.1, -0.2]), np.array([[1.0, 0.3], [0.3, 0.8]])
    j = JEP(jnp.asarray(mu0), jnp.asarray(S0), site(jnp), y, A=jnp.asarray(A))
    m = TEP(mu0, S0, site(torch), y, A=A, device="cpu", dtype=torch.float64)
    return j, m, A, np.array(y), mu0, S0


@pytest.mark.parametrize("kind", ["gaussian", "logistic"])
def test_ep_matches_jax(kind):
    sigma = 0.5
    if kind == "gaussian":
        def site(lib):
            return lambda z, datum: lib.exp(-0.5 * (z - datum) ** 2 / sigma**2)
    else:
        def site(lib):
            sig = torch.sigmoid if lib is torch else jax.nn.sigmoid
            return lambda z, datum: sig(4.0 * z * (1.0 if datum > 0 else -1.0))
    j, m, A, y, mu0, S0 = ep_pair(site)
    mj, Sj = j.fit_gp(iterations=20)
    mt, St = m.fit_gp(iterations=20)
    assert rel(mt, mj) < DET and rel(St, Sj) < DET
    assert rel(m.tau, j.tau) < DET and rel(m.nu, j.nu) < DET
    if kind == "gaussian":
        P0 = np.linalg.inv(S0)
        S_ref = np.linalg.inv(P0 + A.T @ A / sigma**2)
        m_ref = S_ref @ (P0 @ mu0 + A.T @ y / sigma**2)
        assert np.allclose(mt.numpy(), m_ref, atol=1e-4)
        assert np.allclose(St.numpy(), S_ref, atol=1e-4)
