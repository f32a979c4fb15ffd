"""Port parity for the JAX package's last public names: the thin wrappers
`gram_se_df`, `gram_matern_df` (stpy_tpu/ops/pallas_gram_df.py) and
`gemv_df_fused` (pallas_gemv_df.py) against the JAX functions, and
`default_dtype` against the JAX package's f32 meaning (x64 off, as on a TPU).

On the CPU in x64 the JAX functions take their exact float64 branches; the
port's wrappers run the plain PyTorch versions. Bars as the port's `gram_df`
and `gemv_df` parity tests: hi + lo within 1e-13 relative entry by entry
(Gram), within 1e-13 of Σ_j |A_ij|·|v_j| (GEMV).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import stpy_tpu_torch
from stpy_tpu import config as jax_config
from stpy_tpu.ops.pallas_gemv_df import gemv_df_fused as jax_gemv_df_fused
from stpy_tpu.ops.pallas_gram_df import (
    gram_matern_df as jax_gram_matern_df, gram_se_df as jax_gram_se_df,
)
from stpy_tpu_torch import default_dtype, default_jitter
from stpy_tpu_torch.models import GaussianProcess
from stpy_tpu_torch.ops.gemv_df import gemv_df, gemv_df_fused
from stpy_tpu_torch.ops.gram_df import gram_df, gram_matern_df, gram_se_df

from test_torch_port_gemv_df import GEMV_RTOL, df_inputs
from test_torch_port_gram_df import DF_RTOL, entry_rel_err, pair_value
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(19)
    return rng.uniform(-1, 1, (64, 3)), rng.uniform(-1, 1, (48, 3))


def test_gram_se_df_matches_jax(points):
    a, b = points
    jh, jl = jax_gram_se_df(jnp.asarray(a), jnp.asarray(b), 0.7, 1.3)
    th, tl = gram_se_df(torch.as_tensor(a), torch.as_tensor(b), 0.7, 1.3)
    assert th.dtype == tl.dtype == torch.float32
    assert entry_rel_err(pair_value(th, tl), pair_value(jh, jl)) <= DF_RTOL
    # the JAX tile arguments are accepted and change nothing
    bh, bl = gram_se_df(torch.as_tensor(a), torch.as_tensor(b), 0.7, 1.3,
                        block_m=128, block_n=64)
    assert torch.equal(bh, th) and torch.equal(bl, tl)


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5])
def test_gram_matern_df_matches_jax(points, nu):
    a, b = points
    gamma = np.array([0.5, 0.9, 1.3])                        # ARD
    jh, jl = jax_gram_matern_df(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(gamma), 0.8, nu=nu)
    th, tl = gram_matern_df(torch.as_tensor(a), torch.as_tensor(b),
                            torch.as_tensor(gamma), 0.8, nu=nu,
                            block_m=512, block_n=512)
    assert entry_rel_err(pair_value(th, tl), pair_value(jh, jl)) <= DF_RTOL
    gh, gl = gram_df(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(gamma), 0.8, family="matern", nu=nu)
    assert torch.equal(gh, th) and torch.equal(gl, tl)


def test_gram_matern_df_raises_for_a_general_nu_as_jax(points):
    a, b = points
    with pytest.raises(NotImplementedError):
        jax_gram_matern_df(jnp.asarray(a), jnp.asarray(b), 0.7, nu=1.2)
    with pytest.raises(NotImplementedError):
        gram_matern_df(torch.as_tensor(a), torch.as_tensor(b), 0.7, nu=1.2)


@pytest.mark.parametrize("with_vl", [False, True], ids=["v", "v+vl"])
def test_gemv_df_fused_matches_jax(with_vl):
    Ah, Al, v, vl = df_inputs(64, 3, seed=19)
    jvl = jnp.asarray(vl) if with_vl else None
    jh, jl = jax_gemv_df_fused(jnp.asarray(Ah), jnp.asarray(Al),
                               jnp.asarray(v), vl=jvl)
    tvl = torch.as_tensor(vl) if with_vl else None
    args = [torch.as_tensor(t) for t in (Ah, Al, v)]
    th, tl = gemv_df_fused(*args, block_m=128, block_k=256, vl=tvl)
    if not with_vl:
        vl = np.zeros_like(v)
    scale = np.abs(Ah + Al) @ np.abs(v + vl)
    err = np.abs((th.numpy() + tl.numpy())
                 - (np.asarray(jh) + np.asarray(jl))) / scale
    assert th.shape == tl.shape == (64,)
    assert np.max(err) <= GEMV_RTOL
    gh, gl = gemv_df(*args, vl=tvl)
    assert torch.equal(gh, th) and torch.equal(gl, tl)


def test_default_dtype_is_the_jax_f32_meaning():
    with jax.enable_x64(False):
        jax_dtype = jnp.dtype(jax_config.default_dtype())
        jax_jitter = jax_config.default_jitter()
    assert jax_dtype == np.float32
    assert default_dtype() is torch.float32
    assert default_jitter(default_dtype()) == default_jitter() == jax_jitter
    assert default_jitter(torch.float64) == jax_config.default_jitter(
        jnp.float64)


def test_constructors_default_to_default_dtype():
    """Every port class whose constructor takes a dtype defaults it to
    default_dtype(), or to None, which takes the kernel's dtype and else
    default_dtype()."""
    seen = 0
    for info in pkgutil.walk_packages(stpy_tpu_torch.__path__,
                                      "stpy_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if not (inspect.isclass(obj) and obj.__module__ == mod.__name__):
                continue
            param = inspect.signature(obj.__init__).parameters.get("dtype")
            if param is None:
                continue
            seen += 1
            assert param.default in (None, default_dtype()), (mod, name)
    assert seen > 50
    gp = GaussianProcess(gamma=0.5, d=2, device="cpu")
    assert gp.dtype == default_dtype()
