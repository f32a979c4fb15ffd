"""Port parity: the df-entry stage probes of stpy_tpu_torch
(ops/gram_df_stages, probes/exp_r3_df_entry) against host references and
the JAX package's round-3 probe kernels, on the CPU, where each wrapper runs
its plain version.

Tolerances:
- against numpy float64 and 40-digit `decimal`, and against the JAX
  package's f64 reference Gram (`_f64_reference`, x64): 1e-13 relative on
  the pair value hi + lo, the df Gram's DF_RTOL;
- against the JAX probes' own kernels (`_stage_kernel` of
  benchmarks/exp_r3_batch_p.py, `_staged_kernel` of exp_r3_batch_x.py),
  interpreted as the JAX tests run Pallas on the CPU: those kernels hard-wire
  `_make_eft(False)`, no barriers, and interpreted, XLA's simplifier folds
  the error terms of their error-free transforms away. Their √sq is df-grade
  (8.4e-15 here) and is held at 1e-13; their t, e^{-t} and entry are
  f32-grade (P's e^{-t} 5.4e-8, entry 8.4e-8 relative; X's entry 3.7e-8,
  e^{-t} 1.5e-8 absolute; without the suite's AVX pin of XLA:CPU, P's t
  reaches 5.9e-8 and X's squared distance 1.2e-7), held at 2e-7 relative
  (P) and 1e-6 absolute (X);
- against the JAX production df Gram interpreted in f32 with its barriers:
  1e-9 relative, the contract its docstring states ("hi + lo = k(x, y) to
  ~1e-9 relative", stpy_tpu/ops/pallas_gram_df.py:gram_df); measured here
  3.2e-10 on T's points and 3.0e-10 on X's.

T's and U's inline kernels are closures inside their scripts' `main()`; the
production kernel they replay stands in for them.
"""

import functools
import sys
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stpy_tpu.ops.pallas_gram_df import (
    _df_scale_coords, _f64_reference, _round_up, gram_df as jax_gram_df,
)
from stpy_tpu_torch.ops import launch_counts
from stpy_tpu_torch.ops.gram_df import gram_df_scaled, scale_coords
from stpy_tpu_torch.ops.gram_df_stages import (
    ENTRY_STAGES, GRAM_STAGES, df_entry_stage, gram_df_stage,
)
from stpy_tpu_torch.probes import exp_r3_df_entry as probe

from test_torch_port_gram_matvec import _FakeCuda
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
from exp_r3_batch_p import _stage_kernel  # noqa: E402
from exp_r3_batch_x import _staged_kernel  # noqa: E402

DF_RTOL = 1e-13
JAX_PROBE_RTOL = 2e-7            # P's t, e^{-t}, entry: f32-grade interpreted
JAX_STAGED_ATOL = 1e-6           # X's stages: f32-grade interpreted
INTERPRETED_RTOL = 1e-9          # JAX's production df kernel, barriers on
G, NU = probe.G, probe.NU


def pair_value(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def host_stage(sq, stage, nu):
    """The stage in numpy float64, written out apart from the port's."""
    t = np.sqrt(2.0 * nu * sq)
    return {"sq": sq, "sl": np.sqrt(sq), "t": t, "exp": np.exp(-t),
            "entry": ((1 + t) if nu == 1.5 else (1 + t + t * t / 3))
            * np.exp(-t)}[stage]


def decimal_stage(sq, stage, nu):
    with localcontext() as ctx:
        ctx.prec = 40
        sq = Decimal(float(sq))
        t = (2 * Decimal(nu) * sq).sqrt()
        poly = 1 + t if nu == 1.5 else 1 + t + t * t / 3
        return {"sl": sq.sqrt(), "t": t, "exp": (-t).exp(),
                "entry": poly * (-t).exp()}[stage]


@pytest.fixture(scope="module")
def grid():
    """P's grid cut to 8 × 128: (sqh, sql) f32 and their f64 value."""
    return probe.p_grid(small=True)


@pytest.fixture(scope="module")
def x_points():
    """X's slice cut to 256 × 256, f32."""
    return probe.x_slice(small=True)


@pytest.fixture(scope="module")
def t_points():
    """T's points cut to 256 against the next 256, f32."""
    x = probe.t_points()
    return x[:256], x[256:512]


def port_stage(grid, nu, stage):
    sqh, sql, _ = grid
    h, l = df_entry_stage(torch.as_tensor(sqh), torch.as_tensor(sql), nu=nu,
                          stage=stage)
    assert h.dtype == l.dtype == torch.float32 and h.shape == sqh.shape
    return h.numpy(), l.numpy()


@pytest.mark.parametrize("stage", ENTRY_STAGES)
@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_entry_stage_matches_float64_and_decimal(grid, nu, stage):
    h, l = port_stage(grid, nu, stage)
    got, ref = pair_value(h, l), host_stage(grid[2], stage, nu)
    assert np.max(np.abs(got - ref) / ref) <= DF_RTOL
    for k in np.linspace(0, got.size - 1, 32).astype(int):
        with localcontext() as ctx:
            ctx.prec = 40
            want = decimal_stage(grid[2].flat[k], stage, nu)
            have = Decimal(float(h.flat[k])) + Decimal(float(l.flat[k]))
            assert float(abs(have - want) / want) <= DF_RTOL


@pytest.mark.parametrize("stage", ENTRY_STAGES)
@pytest.mark.parametrize("nu", [1.5, 2.5])
def test_entry_stage_matches_the_jax_probe_kernel(grid, nu, stage):
    sqh, sql, _ = grid
    oh, ol = pl.pallas_call(
        functools.partial(_stage_kernel, nu=nu, stage=stage),
        out_shape=[jax.ShapeDtypeStruct(sqh.shape, jnp.float32)] * 2,
        interpret=True,
    )(jnp.asarray(sqh), jnp.asarray(sql))
    want = pair_value(oh, ol)
    got = pair_value(*port_stage(grid, nu, stage))
    tol = DF_RTOL if stage == "sl" else JAX_PROBE_RTOL
    assert np.max(np.abs(got - want) / np.abs(want)) <= tol


def jax_df_coords(x):
    """The JAX probes' df scaled coordinates (hi, lo) of f32 points."""
    inv64 = 1.0 / np.float64(G)
    ih = np.float32(inv64)
    il = np.float32(inv64 - np.float64(ih))
    return _df_scale_coords(jnp.asarray(x), jnp.asarray(ih), jnp.asarray(il))


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


def test_the_probe_meets_every_bar_on_the_cpu(capsys):
    results = probe.run(torch.device("cpu"), small=True)
    want = ({f"P nu={nu} {s}" for nu in probe.P_NUS for s in ENTRY_STAGES}
            | {"T1", "T2", "T3", "T4", "U1", "U2", "U3"}
            | {f"X {label}" for label, _ in probe.X_STAGES})
    assert set(results) == want
    assert [k for k, r in results.items() if not r["ok"]] == []
    out = capsys.readouterr().out
    assert "--small:" in out and "stage=t2" in out and "X acc" in out


def test_main_exits_zero_when_every_stage_meets_its_bar(capsys):
    assert probe.main(["--device", "cpu", "--small"]) == 0
    assert "all 19 stages within 1e-13" in capsys.readouterr().out


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1


def test_unknown_stages_and_shapes_raise(grid, x_points):
    sqh, sql = (torch.as_tensor(v) for v in grid[:2])
    xs, ys = (scale_coords(torch.as_tensor(v), G) for v in x_points)
    for stage in ("t2", "sq", "acc"):
        with pytest.raises(ValueError, match="unknown stage"):
            df_entry_stage(sqh, sql, nu=2.5, stage=stage)
    with pytest.raises(ValueError, match="unknown stage"):
        gram_df_stage(xs, ys, 1.0, family="matern", nu=2.5, stage="sl")
    with pytest.raises(ValueError, match="nu=3.5"):
        df_entry_stage(sqh, sql, nu=3.5, stage="entry")
    with pytest.raises(ValueError, match="laplace"):
        gram_df_stage(xs, ys, 1.0, family="laplace", nu=0.5, stage="entry")
    with pytest.raises(ValueError, match="differ"):
        df_entry_stage(sqh, sql[:4], nu=2.5, stage="entry")


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


def test_empty_shapes_return_empty_pairs_and_cpu_calls_launch_nothing():
    before = launch_counts()
    h, l = gram_df_stage(torch.zeros((0, 3), dtype=torch.float64),
                         torch.zeros((5, 3), dtype=torch.float64), 1.0,
                         family="se", nu=1.5, stage="t")
    assert h.shape == l.shape == (0, 5) and h.dtype == torch.float32
    h, l = df_entry_stage(torch.zeros(0), torch.zeros(0), nu=1.5, stage="exp")
    assert h.shape == l.shape == (0,) and h.dtype == torch.float32
    for stage in GRAM_STAGES:
        gram_df_stage(torch.ones((2, 3), dtype=torch.float64),
                      torch.zeros((4, 3), dtype=torch.float64), 1.0,
                      family="matern", nu=0.5, stage=stage)
    assert launch_counts() == before
