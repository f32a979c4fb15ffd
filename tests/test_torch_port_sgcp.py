"""Port parity: stpy_tpu_torch/approx_inference/sgcp.py against
stpy_tpu/approx_inference/sgcp.py on the CPU: the state at construction
and the ELBO.

A 1-D SGCP (40 numpy-seeded events, 12 inducing points, 64 quadrature
nodes, and the same model without events) is built by both packages, JAX
in x64 and torch in float64: the inducing grid, quadrature, factor,
cross-covariances and the ELBO at two parameter sets agree within 1e-10
relative. The Adam fit is held in tests/test_torch_port_sgcp_fit.py, the
rate functions and sampled bands in tests/test_torch_port_sgcp_rates.py
and the corrected bands in tests/test_torch_port_sgcp_bands.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.approx_inference.sgcp import SGCPVariational as JSG
from stpy_tpu.domains import BorelSet as JBox
from stpy_tpu.kernels import KernelFunction as JK
from stpy_tpu_torch.approx_inference import sgcp as tsg
from stpy_tpu_torch.convert import load_sgcp_state
from stpy_tpu_torch.domains import BorelSet as TBox
from stpy_tpu_torch.kernels import KernelFunction as TK

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
ITER = 1e-6
SAMPLER = 1e-8
F64 = jnp.float64

_OBS = np.random.default_rng(81).uniform(-0.8, 0.2, (40, 1))
_XT = np.linspace(-1, 1, 32)[:, None]


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def make(obs=_OBS, gamma=0.4, inducing=12, integration=64, **kw):
    j = JSG(JK(kernel_name="squared_exponential", gamma=gamma, d=1),
            JBox(1, [[-1.0, 1.0]]),
            None if obs is None else jnp.asarray(obs),
            num_inducing=inducing, num_integration=integration, **kw)
    t = tsg.SGCPVariational(
        TK(kernel_name="squared_exponential", gamma=gamma, d=1, device="cpu",
           dtype=torch.float64),
        TBox(1, [[-1.0, 1.0]], device="cpu", dtype=torch.float64), obs,
        num_inducing=inducing, num_integration=integration, device="cpu",
        **kw)
    return j, t


def random_params(M, seed):
    rng = np.random.default_rng(seed)
    return {"m": rng.standard_normal(M),
            "L_raw": 0.1 * rng.standard_normal((M, M)),
            "log_lam": np.array(np.log(30.0))}


def carried(steps=100):
    """The small model fitted `steps` Adam steps by the JAX package, its
    state carried to the port (`convert.load_sgcp_state`)."""
    j, t = make()
    j.run(steps=steps)
    load_sgcp_state(t, j.params["m"], j.params["L_raw"], j.params["log_lam"])
    return j, t


@pytest.mark.parametrize("obs", ["events", "none"])
def test_state_and_elbo_match_jax(obs):
    """The ELBO of the JAX package runs under `jax.jit`."""
    j, t = make(None if obs == "none" else _OBS)
    for name in ("Z", "int_w", "int_x", "Lz", "Kxz_int", "kdiag_int"):
        assert rel(getattr(t, name), getattr(j, name)) < DET, name
    if obs == "events":
        assert rel(t.Kxz_obs, j.Kxz_obs) < DET
    assert t.M == j.M
    elbo = jax.jit(j._elbo)
    for seed in (None, 3):
        if seed is None:
            pj, pt = j.params, t.params
        else:
            p = random_params(j.M, seed)
            pj = {k: jnp.asarray(v) for k, v in p.items()}
            pt = {k: torch.tensor(v) for k, v in p.items()}
        assert rel(t._elbo(pt), elbo(pj)) < DET


def feed_normal(monkeypatch, draws):
    it = iter(draws)
    monkeypatch.setattr(tsg, "_normal",
                        lambda *a, **k: torch.tensor(np.asarray(next(it))))


def test_sgcp_defaults_to_the_card_and_never_the_cpu(monkeypatch):
    k = TK(gamma=0.4, d=1, device="cpu")
    S = TBox(1, [[-1.0, 1.0]], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsg.SGCPVariational(k, S, _OBS)
    sg = tsg.SGCPVariational(k, S, _OBS, device="cpu")
    assert sg.Lz.device.type == "cpu" and sg.Lz.dtype == torch.float32
    assert np.isfinite(sg.run(steps=5))


def test_f32_model_builds_its_constants_in_float64():
    """Departure: with 16² inducing points 1/15 apart on the unit square
    and SE γ = 0.15, the f32 factor of the inducing Gram fails at the
    default jitter (the JAX package's f32 model, which factors it in f32,
    has a NaN ELBO there); the port factors Kzz and forms A = Lz⁻¹Kzx in
    float64 from the double-float Gram, and its f32 ELBO is finite and
    within 1e-5 of the float64 model's."""
    from stpy_tpu_torch.linalg import chol_jittered

    def model(dt):
        k = TK(kernel_name="squared_exponential", gamma=0.15, d=2,
               device="cpu", dtype=dt)
        S = TBox(2, [[0.0, 1.0], [0.0, 1.0]], device="cpu", dtype=dt)
        obs = np.random.default_rng(3).uniform(0, 1, (60, 2))
        return k, tsg.SGCPVariational(k, S, obs, num_inducing=256,
                                      num_integration=256, device="cpu")

    k32, m32 = model(torch.float32)
    _, m64 = model(torch.float64)
    assert not bool(torch.isfinite(chol_jittered(k32.gram(m32.Z), 1e-6))
                    .all())
    assert m32.Lz.dtype == torch.float32 and bool(torch.isfinite(m32.A_int)
                                                  .all())
    e32, e64 = m32._elbo(m32.params), m64._elbo(m64.params)
    assert np.isfinite(float(e32))
    assert abs(float(e32) - float(e64)) / abs(float(e64)) < 1e-5
