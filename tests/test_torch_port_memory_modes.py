"""Port parity: the exact GP's memory modes against stpy_tpu on the CPU:
`linalg.safe_cholesky_rebuild`, ``jitter_ladder="recompute"`` in the single
and double tiers, ``fold_noise=True`` at var_refine 0 and 1 on a two-atom
kernel, and `df_gram_from_desc(strip_fold=)` on a composite.

The same numpy data goes through both packages (JAX in x64, torch in
float64), with the bars of tests/test_torch_port_exact_gp.py: posterior
mean within 1e-8 relative to its largest entry, std within 1e-6 entry by
entry. Against the port's own standard layout, `fold_noise` is held at the
JAX package's own tolerance between its two layouts, 1e-10 absolute
(tests/test_exact_gp.py:360-390); the recompute ladder at 1e-8
(tests/test_exact_gp.py:338-357). The ladders' factors and jitters 1e-12;
the strip-folded Gram bit for bit against the full fold and 1e-13 relative
against the JAX one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu import linalg as jax_linalg
from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu_torch import GaussianProcess as TorchGP
from stpy_tpu_torch import linalg
from stpy_tpu_torch.kernels import df_plan

from test_torch_port_exact_gp import (  # noqa: F401 (module fixtures)
    S, assert_posterior_close, data, gp_pair, pinned_torch_state,
)
from test_torch_port_gram import jax_kernel, torch_kernel

TWO_ATOMS = "se+matern32"
LAYOUT_ATOL = 1e-10
LADDER_ATOL = 1e-8
FACTOR_ATOL = 1e-12


def indefinite(n=12):
    """tests/test_exact_gp.py:392-410's matrix: one eigenvalue −1e-9, so
    the ladder climbs until j·scale > 1e-9."""
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(1.0, 0.1, n)
    lam[-1] = -1e-9
    return Q @ np.diag(lam) @ Q.T


def test_safe_cholesky_rebuild_escalates_like_jax_and_safe_cholesky():
    K = indefinite()
    n = K.shape[0]
    want = jax_linalg.safe_cholesky_rebuild(
        lambda j: jnp.asarray(K) + j * jnp.eye(n), jnp.mean(jnp.diagonal(K)))
    Kt = torch.as_tensor(K)
    builds = []

    def build(j):
        builds.append(float(j))
        return Kt + j * torch.eye(n, dtype=Kt.dtype)

    got = linalg.safe_cholesky_rebuild(build, torch.mean(torch.diagonal(Kt)))
    ref = linalg.safe_cholesky(Kt.clone())
    assert bool(got.ok) and bool(want.ok) and bool(ref.ok)
    assert float(got.jitter) > 1e-9 and len(builds) > 1     # it escalated
    for other in (float(want.jitter), float(ref.jitter)):
        assert abs(float(got.jitter) - other) <= FACTOR_ATOL * other
    assert np.max(np.abs(got.L.numpy() - np.asarray(want.L))) <= FACTOR_ATOL
    assert np.max(np.abs(got.L.numpy() - ref.L.numpy())) <= FACTOR_ATOL


def test_safe_cholesky_rebuild_reports_failure_without_raising():
    K = torch.as_tensor(indefinite()) - torch.eye(12, dtype=torch.float64)
    res = linalg.safe_cholesky_rebuild(
        lambda j: K + j * torch.eye(12, dtype=K.dtype), 1.0, max_tries=2)
    want = jax_linalg.safe_cholesky_rebuild(
        lambda j: jnp.asarray(K.numpy()) + j * jnp.eye(12), 1.0, max_tries=2)
    assert not bool(res.ok) and not bool(want.ok)
    assert torch.isnan(res.L).all()
    assert float(res.jitter) == pytest.approx(float(want.jitter), rel=1e-12)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_recompute_ladder_matches_jax_and_the_kept_gram_ladder(data,
                                                               precision):
    """``jitter_ladder="recompute"``: each attempt rebuilds K + (s² + j)I
    (the single tier from the kernel, the double tier from its df Gram's
    hi part) and factors it in place."""
    x, y, xt = data
    jg, tg = gp_pair(TWO_ATOMS, precision=precision,
                     jitter_ladder="recompute")
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    got = tg.fit_predict(x, y, xt)
    assert_posterior_close(got, want)
    assert tg.fit_status["cholesky_ok"] is True
    assert tg.fit_status["jitter_used"] == pytest.approx(
        jg.fit_status["jitter_used"], rel=1e-6)
    kept = TorchGP(kernel=torch_kernel(TWO_ATOMS), s=S, precision=precision)
    for a, b in zip(got, kept.fit_predict(x, y, xt)):
        assert np.max(np.abs(a.numpy() - b.numpy())) <= LADDER_ATOL


def test_recompute_ladder_escalates_in_the_gp_as_the_kept_gram_ladder():
    """Duplicated points and a smooth kernel (SE, γ = 2) make the f32 Gram
    indefinite beyond the first rung (1e-6 of its mean diagonal), so the
    ladder climbs; the recompute ladder lands on the same rung as the
    kept-Gram one and on the same posterior. (The JAX package's models run
    in float64 under the tests' x64, where the port's float64 model on
    duplicated points stayed on the first rung.)"""
    rng = np.random.default_rng(4)
    x = np.repeat(rng.uniform(-1, 1, (100, 3)), 2, axis=0)
    y = np.sin(3 * x[:, :1])
    xt = rng.uniform(-1, 1, (10, 3))
    fits = []
    for ladder in ("recompute", True):
        k = torch_kernel("se", dtype=torch.float32)
        k.params_dict["0"]["gamma"] = torch.tensor(2.0, dtype=torch.float64)
        gp = TorchGP(kernel=k, s=0.0, jitter_ladder=ladder)
        fits.append((gp.fit_predict(x, y, xt), gp.fit_status))
    (got, st_r), (want, st_k) = fits
    assert st_r["cholesky_ok"] and st_r["jitter_used"] > 2e-6
    assert st_r["jitter_used"] == st_k["jitter_used"]
    for a, b in zip(got, want):
        assert np.max(np.abs(a.numpy() - b.numpy())) <= 1e-5 * np.max(
            np.abs(b.numpy()))


@pytest.mark.parametrize("var_refine", [0, 1])
def test_fold_noise_matches_jax_and_the_standard_layout(data, var_refine):
    """``fold_noise=True``: s² and the jitter folded into the df Gram's
    diagonal, Kh factored as it stands, the jitter unfolded; the system of
    the refinement and the quadratic form stays K + s²I, and the two-atom
    Gram is strip-folded."""
    x, y, xt = data
    kw = dict(precision="double", var_refine=var_refine, jitter_ladder=False)
    jg, tg = gp_pair(TWO_ATOMS, fold_noise=True, **kw)
    want = jg.fit_predict(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt))
    got = tg.fit_predict(x, y, xt)
    assert_posterior_close(got, want)
    assert tg.fit_status["cholesky_ok"] is True
    std = TorchGP(kernel=torch_kernel(TWO_ATOMS), s=S, **kw)
    for a, b in zip(got, std.fit_predict(x, y, xt)):
        assert np.max(np.abs(a.numpy() - b.numpy())) <= LAYOUT_ATOL
    tg.fit_gp(x, y)           # the two-call path takes the same branch
    for a, b in zip(tg.mean_std(xt), got):
        assert np.max(np.abs(a.numpy() - b.numpy())) <= 1e-12


def test_fold_noise_needs_the_double_tier_and_a_fixed_jitter():
    with pytest.raises(ValueError):
        TorchGP(kernel=torch_kernel("se"), fold_noise=True)
    with pytest.raises(ValueError):
        TorchGP(kernel=torch_kernel("se"), precision="double",
                fold_noise=True)


def test_strip_fold_matches_the_full_fold_and_jax():
    """tests/test_df_interp.py:254-280's composite (SE + Matérn-3/2 + a
    generic linear atom), 200 rows in strips of 64."""
    def mk(cls_kernel):
        return cls_kernel("se") + cls_kernel("matern32")

    from stpy_tpu_torch.kernels import KernelFunction

    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (130, 3)).astype(np.float32)
    lin = KernelFunction(kernel_name="linear", d=3, device="cpu")
    k1 = mk(lambda c: torch_kernel(c, dtype=torch.float32)) + lin
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    full = df_plan.df_gram_from_desc(k1, {}, ta, tb, df_plan.df_atom_desc(k1))
    strip = df_plan.df_gram_from_desc(k1, {}, ta, tb,
                                      df_plan.df_atom_desc(k1), strip_fold=64)
    for f, s_ in zip(full, strip):
        assert torch.equal(f, s_)
    from stpy_tpu.kernels import KernelFunction as JaxKernel

    jk = mk(jax_kernel) + JaxKernel(kernel_name="linear", d=3)
    jh, jl = jax_df_plan.df_gram_from_desc(
        jk, {}, jnp.asarray(a), jnp.asarray(b),
        jax_df_plan.df_atom_desc(jk), strip_fold=64)
    want = np.asarray(jh, np.float64) + np.asarray(jl, np.float64)
    got = strip[0].double().numpy() + strip[1].double().numpy()
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
