"""Port parity: the stage launch of csrc/gram_df.cu (`gram_df_stage`,
the port of the round-3 probes' d-loop and staged kernels) against the
JAX probe kernels and the JAX df Gram on the CPU: its entry is the
production Gram's, its sq the float64 sum of squares, and every stage the
JAX staged kernel's, with the bars of tests/test_torch_port_df_stages.py
(which holds the entry stages and the probe).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stpy_tpu.ops.pallas_gram_df import (
    _f64_reference,
    _round_up,
    gram_df as jax_gram_df,
)
from stpy_tpu_torch.ops.gram_df import gram_df_scaled, scale_coords
from stpy_tpu_torch.ops.gram_df_stages import df_entry_stage, gram_df_stage
from stpy_tpu_torch.probes import exp_r3_df_entry as probe

from test_torch_port_df_stages import (
    DF_RTOL, G, INTERPRETED_RTOL, JAX_STAGED_ATOL, NU, grid, jax_df_coords,
    pair_value, t_points, x_points,
)
from test_torch_port_gram_matvec import _FakeCuda
from torch_threads import one_torch_thread  # noqa: F401

# benchmarks/ is on the path once test_torch_port_df_stages is imported
from exp_r3_batch_x import _staged_kernel  # noqa: E402


@pytest.mark.parametrize("label,stage", probe.X_STAGES)
def test_gram_stage_matches_the_jax_staged_kernel(x_points, label, stage):
    """X's `_staged_kernel` with the production BlockSpecs (grid, (8, 256)
    y windows, κ in SMEM) on one 256 × 256 grid block; the port takes the
    f64 value of the same df coordinates."""
    rows, cols = x_points
    (ah, al), (bh, bl) = jax_df_coords(rows), jax_df_coords(cols)
    n, d = rows.shape
    dp, dx = _round_up(d, 8), _round_up(d, 128)
    padx = functools.partial(jnp.pad, pad_width=((0, 0), (0, dx - d)))

    def pady(a):
        return jnp.pad(a, ((0, 0), (0, dp - d))).T

    oh, ol = pl.pallas_call(
        functools.partial(_staged_kernel, d=d, family="matern", nu=NU,
                          stage=label),
        grid=(1, 1),
        in_specs=[
            pl.BlockSpec((1, 2), lambda i, j: (0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((n, dx), lambda i, j: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((n, dx), lambda i, j: (i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((dp, n), lambda i, j: (0, j),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((dp, n), lambda i, j: (0, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[pl.BlockSpec((n, n), lambda i, j: (i, j),
                                memory_space=pltpu.VMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((n, n), jnp.float32)] * 2,
        interpret=True,
    )(jnp.asarray(np.array([[1.0, 0.0]], np.float32)), padx(ah), padx(al),
      pady(bh), pady(bl))
    a64, b64 = pair_value(ah, al), pair_value(bh, bl)
    got = pair_value(*gram_df_stage(torch.as_tensor(a64),
                                    torch.as_tensor(b64), 1.0,
                                    family="matern", nu=NU, stage=stage))
    assert np.max(np.abs(got - pair_value(oh, ol))) <= JAX_STAGED_ATOL


@pytest.mark.parametrize("mode", ["x64", "interpreted"])
@pytest.mark.parametrize("which", ["t", "x"])
def test_gram_stage_entry_matches_the_jax_df_gram(t_points, x_points, which,
                                                  mode):
    """The port's stage "entry" against the JAX package's production df
    Matérn-5/2 Gram (γ = 1.1): its x64 reference, and its kernel
    interpreted in f32 with barriers."""
    a, b = t_points if which == "t" else x_points
    if mode == "x64":
        jh, jl = _f64_reference(jnp.asarray(a, jnp.float64),
                                jnp.asarray(b, jnp.float64), G, 1.0,
                                "matern", NU)
        tol = DF_RTOL
    else:
        jh, jl = jax_gram_df(jnp.asarray(a), jnp.asarray(b), G, 1.0,
                             family="matern", nu=NU, interpret=True)
        tol = INTERPRETED_RTOL
    xs, ys = (scale_coords(torch.as_tensor(v), G) for v in (a, b))
    got = pair_value(*gram_df_stage(xs, ys, 1.0, family="matern", nu=NU,
                                    stage="entry"))
    want = pair_value(jh, jl)
    assert np.max(np.abs(got - want) / want) <= tol


@pytest.mark.parametrize("which", ["t", "x"])
def test_gram_stage_sq_is_the_f64_sum_of_squares(t_points, x_points, which):
    a, b = t_points if which == "t" else x_points
    xs, ys = (scale_coords(torch.as_tensor(v), G) for v in (a, b))
    a64, b64 = xs.numpy(), ys.numpy()
    want = ((a64[:, None, :] - b64[None, :, :]) ** 2).sum(-1)
    got = pair_value(*gram_df_stage(xs, ys, 1.0, family="matern", nu=NU,
                                    stage="sq"))
    assert np.max(np.abs(got - want) / want.max(1, keepdims=True)) <= DF_RTOL


@pytest.mark.parametrize("family,nu", [("se", 1.5), ("matern", 0.5),
                                       ("matern", 1.5), ("matern", 2.5)])
def test_gram_stage_entry_is_the_production_gram(x_points, family, nu):
    xs, ys = (scale_coords(torch.as_tensor(v), G) for v in x_points)
    sh, sl = gram_df_stage(xs, ys, 1.3, family=family, nu=nu, stage="entry")
    ph, pl_ = gram_df_scaled(xs, ys, 1.3, family, nu)
    assert torch.equal(sh, ph) and torch.equal(sl, pl_)


def test_cuda_wrappers_take_float64_coordinates_and_f32_pairs(grid, x_points):
    xs, ys = (scale_coords(torch.as_tensor(v), G) for v in x_points)
    with pytest.raises(TypeError, match="float64"):
        gram_df_stage(xs.float().as_subclass(_FakeCuda),
                      ys.as_subclass(_FakeCuda), 1.0, family="matern",
                      nu=2.5, stage="entry")
    sqh, sql = (torch.as_tensor(v) for v in grid[:2])
    with pytest.raises(TypeError, match="float32"):
        df_entry_stage(sqh.double().as_subclass(_FakeCuda),
                       sql.as_subclass(_FakeCuda), nu=2.5, stage="entry")
