"""Port parity: the fits and warnings of `IterativeGP` in
stpy_tpu_torch/parallel/iterative.py against stpy_tpu's on the CPU (n =
256, d = 3): the df-refined matrix-free variance, the general tier's
`optimize_params` on the same probes, the maxiter and stall warnings, the
f32 model against the float64 one, and the segmented dispatch above
n = 32768.

The same numpy data goes through both packages, JAX in x64 and torch in
float64; the bars are those of tests/test_torch_port_iterative.py, which
holds the solvers and preconditioners.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.parallel import iterative as jit_
from stpy_tpu_torch.parallel import iterative as tit

from test_torch_port_gram import torch_kernel
from test_torch_port_iterative import (
    MEAN_RTOL, S, df_variance_case, df_variance_data, gp_data, gp_pair,
    one_torch_thread, rel_err, same_probes,
)


@pytest.mark.parametrize("lazy", [True, False])
def test_df_refined_variance_matches_jax(df_variance_data, lazy):
    """`_std_exact_df` (precision="double", var_refine=1, both tiers)
    against the JAX package's and against the dense double tier's refined
    variance (tests/test_parallel.py:552-590 and its bars: mean within
    1e-7, variance within 1e-6 relative); the port and the JAX package
    agree to 1e-10 on the variance."""
    from stpy_tpu.kernels import KernelFunction as JaxKernel
    from stpy_tpu.models import GaussianProcess as JaxGP
    from stpy_tpu_torch import KernelFunction as TorchKernel

    x, y, xt = df_variance_data
    kw = dict(s=0.2, lazy=lazy, precision="double", tol=1e-9, maxiter=800,
              df_chunk=64)
    jg = jit_.IterativeGP(df_variance_case(JaxKernel), var_refine=1, **kw)
    tg = tit.IterativeGP(df_variance_case(TorchKernel, device="cpu",
                                          dtype=torch.float64), **kw)
    assert tg.var_refine == 1     # the constructor's default
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    jm, js = jg.mean_std(jnp.asarray(xt), method="exact")
    tm, ts = tg.mean_std(xt, method="exact")
    assert ts.shape == (140, 1)
    tv, jv = ts.numpy().ravel() ** 2, np.asarray(js).ravel() ** 2
    assert np.max(np.abs(tv - jv) / jv) <= 1e-10
    assert rel_err(tm.numpy(), jm) <= MEAN_RTOL
    ref = JaxGP(kernel=df_variance_case(JaxKernel), s=0.2,
                precision="double", var_refine=1)
    ref.fit_gp(jnp.asarray(x), jnp.asarray(y))
    mu_ref, std_ref = ref.mean_std(jnp.asarray(xt))
    v_ref = np.asarray(std_ref).ravel() ** 2
    assert np.max(np.abs(tm.numpy() - np.asarray(mu_ref))) < 1e-7
    assert np.max(np.abs(tv - v_ref) / np.maximum(v_ref, 1e-12)) < 1e-6


@pytest.mark.parametrize("case", ["matern32*laplace", "laplace"])
def test_general_optimize_params_writes_back_like_jax(gp_data, case,
                                                      same_probes):
    """A kernel that is not a sum of fused atoms fits on bbmm's general
    tier: every gamma / kappa leaf and the noise, written back into the
    params dict and `s`, then refitted, as the JAX package does (1e-7,
    the evidence tests' bar)."""
    x, y, xt = gp_data
    x, y = x[:80], y[:80]
    same_probes(np.random.default_rng(7).choice([-1.0, 1.0], (80, 8)))
    jg, tg = gp_pair(case, lazy=True, chunk=32, precond_rank=0)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    kw = dict(optimize=("gamma", "kappa", "noise"), steps=3, lr=0.15,
              probes=8, tol=0.0, cg_tol=1e-12, cg_maxiter=800,
              probe_tol=1e-12, probe_maxiter=800)
    jout = jg.optimize_params(**kw)
    tout = tg.optimize_params(**kw)
    assert tout["steps_run"] == jout["steps_run"] == 3
    for idx, p in tg.kernel_object.params_dict.items():
        for key, val in p.items():
            want = np.asarray(jg.kernel_object.params_dict[idx][key])
            assert val.dtype == torch.float64
            assert tuple(val.shape) == want.shape, (idx, key)
            assert rel_err(val.numpy(), want) <= 1e-7, (idx, key)
    assert abs(tg.s - jg.s) <= 1e-7 * jg.s and tg.s != S
    assert tg.fit_status["converged"]
    assert rel_err(tg.mean(xt).numpy(), jg.mean(jnp.asarray(xt))) <= 1e-6


def test_maxiter_and_stall_warnings_match_jax(gp_data):
    x, y, _ = gp_data
    jg, tg = gp_pair("se", lazy=True, maxiter=5)
    with pytest.warns(UserWarning, match="hit maxiter=5"):
        jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    with pytest.warns(UserWarning, match="hit maxiter=5"):
        tg.fit_gp(x, y)
    assert tg.fit_status == {**jg.fit_status,
                             "cg_residual": tg.fit_status["cg_residual"]}
    assert not tg.fit_status["converged"] and not tg.cg_stalled
    # a double fit whose inner solve makes no progress warns too
    tg = tit.IterativeGP(torch_kernel("se"), s=S, lazy=True, maxiter=1,
                         precision="double", var_refine=0)
    with pytest.warns(UserWarning, match="not contracting"):
        tg.fit_gp(x, y)


def test_stalled_fit_is_reported_and_warned(gp_data, monkeypatch):
    # a solve that stops short of tol before maxiter: the stagnation
    # warning and fit_status, as the JAX package reports them
    x, y, _ = gp_data
    real = tit.cg_solve
    monkeypatch.setattr(
        tit, "cg_solve",
        lambda *a, **k: (lambda out: (out[0], 300, torch.tensor(3e-6)))(
            real(*a, **k)))
    gp = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    with pytest.warns(UserWarning, match="stagnated at relative residual"):
        gp.fit_gp(x, y)
    assert gp.cg_stalled and gp.fit_status["stalled_at_floor"]
    assert not gp.fit_status["converged"]
    assert gp.fit_status["cg_iterations"] == 300


def test_f32_model_on_the_cpu_matches_the_f64_model(gp_data):
    x, y, xt = gp_data
    gp = tit.IterativeGP(torch_kernel("se+matern32", dtype=torch.float32),
                         s=S, tol=1e-6, lazy=True)
    gp.fit_gp(x, y)
    ref = tit.IterativeGP(torch_kernel("se+matern32"), s=S, tol=1e-12,
                          lazy=True)
    ref.fit_gp(x, y)
    mu, sd = gp.mean_std(xt)
    assert mu.dtype == sd.dtype == torch.float32
    assert rel_err(mu.numpy(), ref.mean(xt).numpy()) <= 1e-4


def test_segmented_dispatch_above_32768(monkeypatch, gp_data):
    # the port runs the fit and the exact variance (f32 and df-refined) on
    # the single-loop solvers at any n: no size switches to the segmented
    # ones, which the JAX package takes above 32768 (a TPU workaround)
    x, y, xt = gp_data
    calls = []
    for name in ("cg_solve", "cg_solve_block", "cg_solve_segmented",
                 "cg_solve_block_segmented"):
        real = getattr(tit, name)
        monkeypatch.setattr(
            tit, name,
            lambda *a, _real=real, _name=name, **k: calls.append(_name)
            or _real(*a, **k))
    assert not hasattr(tit, "SEGMENT_ABOVE")
    gp = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    gp.fit_gp(x, y)
    gp.mean_std(xt)
    # the fit's solve, then one block solve per 128-column block
    assert calls == ["cg_solve"] + ["cg_solve_block"] * 2
    calls.clear()
    gpd = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True,
                          precision="double", df_chunk=100)
    gpd.fit_gp(x[:120], y[:120])
    gpd.mean_std(xt[:20])
    assert set(calls) == {"cg_solve", "cg_solve_block"}
    ref = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    ref.fit_gp(x, y)
    seg, _, _ = tit.cg_solve_segmented(ref._matvec, torch.as_tensor(y[:, 0]),
                                       tol=1e-10, maxiter=600)
    assert rel_err(gp.A[:, 0].numpy(), seg.numpy()) <= 1e-8
