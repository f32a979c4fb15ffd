"""Port parity: the exact double-float GEMV of stpy_tpu_torch against
stpy_tpu.

On the CPU in x64 the JAX `gemv_df_fused` takes its f64 branch
(pallas_gemv_df.py:169-174); the port's wrapper runs its plain PyTorch
version. Tolerance: hi + lo within 1e-13 of Σ_j |A_ij|·|v_j| — both are f64
GEMVs that sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.ops.pallas_gemv_df import gemv_df_fused
from stpy_tpu_torch.ops.gemv_df import gemv_df

GEMV_RTOL = 1e-13


def df_inputs(m, k, seed):
    """f32-valued Ah, v and their lo companions Al, vl (|lo| ~ eps32)."""
    rng = np.random.default_rng(seed)
    Ah = rng.standard_normal((m, k)).astype(np.float32).astype(np.float64)
    Al = (Ah * rng.uniform(-6e-8, 6e-8, (m, k))).astype(np.float32)
    v = rng.standard_normal(k).astype(np.float32).astype(np.float64)
    vl = (v * rng.uniform(-6e-8, 6e-8, k)).astype(np.float32)
    return Ah, Al.astype(np.float64), v, vl.astype(np.float64)


@pytest.mark.parametrize("with_vl", [False, True], ids=["v", "v+vl"])
@pytest.mark.parametrize("m,k", [(1, 1), (7, 300), (64, 64), (100, 33)])
def test_gemv_df_matches_jax_f64_branch(m, k, with_vl):
    Ah, Al, v, vl = df_inputs(m, k, seed=m * 1000 + k)
    if not with_vl:
        vl = np.zeros_like(v)
    jh, jl = gemv_df_fused(jnp.asarray(Ah), jnp.asarray(Al), jnp.asarray(v),
                           vl=jnp.asarray(vl) if with_vl else None)
    th, tl = gemv_df(*(torch.as_tensor(t) for t in (Ah, Al, v)),
                     vl=torch.as_tensor(vl) if with_vl else None)
    assert th.shape == tl.shape == (m,)
    scale = np.abs(Ah + Al) @ np.abs(v + vl)
    err = np.abs((th.numpy() + tl.numpy())
                 - (np.asarray(jh) + np.asarray(jl))) / scale
    assert np.max(err) <= GEMV_RTOL


@pytest.mark.parametrize("m,k", [(33, 70), (1, 129), (200, 3)])
def test_gemv_df_f32_pair_in_f32_pair_out(m, k):
    Ah, Al, v, vl = df_inputs(m, k, seed=3)
    args = [torch.as_tensor(t, dtype=torch.float32) for t in (Ah, Al, v, vl)]
    h, l = gemv_df(*args[:3], vl=args[3][:, None])
    assert h.dtype == l.dtype == torch.float32
    exact = (Ah + Al) @ (v + vl)
    scale = np.abs(Ah + Al) @ np.abs(v + vl)
    got = h.double().numpy() + l.double().numpy()
    assert np.max(np.abs(got - exact) / scale) <= GEMV_RTOL


def test_gemv_df_rejects_mismatched_shapes():
    A = torch.zeros((4, 5))
    with pytest.raises(ValueError):
        gemv_df(A, A, torch.zeros(4))
    with pytest.raises(ValueError):
        gemv_df(A, torch.zeros((4, 4)), torch.zeros(5))
