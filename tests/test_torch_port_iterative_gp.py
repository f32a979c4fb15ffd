"""Port parity: `IterativeGP` of stpy_tpu_torch/parallel/iterative.py
against stpy_tpu's at small size (n = 256, d = 3) on the CPU: the fit and
posterior of every tier (lazy and dense, single and double, sum and
product kernels), the preconditioner's landmarks, the Hutchinson
variance, the pathwise samples on fed draws, the loaded JAX state and the
model's device.

The same numpy data goes through both packages, JAX in x64 and torch in
float64. The posterior is held at 1e-8 relative (mean, to its largest
entry) and 1e-6 (std, entry by entry) with tol = 1e-10, as in
tests/test_torch_port_iterative.py, which holds the solvers and
preconditioners; the matrix-free fits are in
tests/test_torch_port_iterative_fit.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import functions as JF
from stpy_tpu_torch.convert import load_iterative_state
from stpy_tpu_torch.parallel import iterative as tit

from test_torch_port_gram import torch_kernel
from test_torch_port_iterative import (
    MEAN_RTOL, S, assert_posterior_close, gp_data, gp_pair, one_torch_thread,
    rel_err,
)


@pytest.mark.parametrize("case", ["se", "se+matern32", "ard*matern52"])
@pytest.mark.parametrize("lazy", [True, False])
def test_single_tier_fit_mean_std_matches_jax(gp_data, case, lazy):
    x, y, xt = gp_data
    jg, tg = gp_pair(case, lazy=lazy, chunk=100)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    # on this clustered spectrum the iteration counts may part by a few
    # (see `system`); both converge
    assert abs(tg.cg_iterations - jg.cg_iterations) <= 5
    assert tg.fit_status == {**jg.fit_status,
                             "cg_iterations": tg.cg_iterations,
                             "cg_residual": tg.fit_status["cg_residual"]}
    assert tg.fit_status["converged"]
    assert rel_err(tg.mean(xt).numpy(), jg.mean(jnp.asarray(xt))) <= MEAN_RTOL
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


@pytest.mark.parametrize("case", ["se", "se+matern32"])
def test_double_tier_fit_mean_std_matches_jax(gp_data, case):
    x, y, xt = gp_data
    jg, tg = gp_pair(case, lazy=True, precision="double", var_refine=0)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    assert tg._A_df.shape == (256, 2)
    assert torch.equal(tg.A, tg._A_df[:, :1])
    assert len(tg.df_residuals) == len(jg.df_residuals) == 2
    # each is the exact residual of a converged f64 solve (tol 1e-10)
    assert max(tg.df_residuals + list(jg.df_residuals)) <= 1e-9
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_explicit_precond_rank_converges_to_the_jax_solution(gp_data):
    x, y, xt = gp_data
    jg, tg = gp_pair("se+matern32", lazy=True, precond_rank=48)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    plain = tit.IterativeGP(torch_kernel("se+matern32"), s=S, tol=1e-10,
                            maxiter=600, lazy=True, precond_rank=0)
    plain.fit_gp(x, y)
    # the landmark draws differ, the converged posterior does not; and the
    # rank-48 preconditioner takes far fewer iterations than none
    assert tg.fit_status["converged"] and jg.fit_status["converged"]
    assert tg.cg_iterations < 0.5 * plain.cg_iterations
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_landmarks_come_from_the_generator(gp_data):
    x, y, xt = gp_data
    runs = []
    for seed in (0, 0, 1):
        gp = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True,
                             precond_rank=32,
                             generator=torch.Generator().manual_seed(seed))
        gp.fit_gp(x, y)
        runs.append((gp.cg_iterations, gp.A))
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], runs[2][1])
    assert rel_err(runs[2][1].numpy(), runs[0][1].numpy()) <= 1e-7


def test_hutchinson_variance_is_within_its_probe_error_of_the_exact(gp_data):
    x, y, xt = gp_data
    gp = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    gp.fit_gp(x, y)
    _, sd_exact = gp.mean_std(xt, method="exact")
    probes = 400
    mu, sd = gp.mean_std(xt, probes=probes, method="hutchinson",
                         generator=torch.Generator().manual_seed(3))
    assert torch.allclose(mu, gp.mean(xt))
    # per test point the Rademacher estimate of diag(M), M = K* A⁻¹ K*ᵀ,
    # has variance Σ_{j≠i} M_ij² / probes
    ko = gp.kernel_object
    Ks = ko.cross(torch.as_tensor(xt), gp.x)
    A = ko.gram(gp.x) + S * S * torch.eye(256, dtype=torch.float64)
    M = Ks @ torch.linalg.solve(A, Ks.T)
    se = torch.sqrt((torch.sum(M * M, 1) - torch.diagonal(M) ** 2) / probes)
    err = (sd[:, 0] ** 2 - sd_exact[:, 0] ** 2).abs()
    assert bool(torch.all(err <= 5 * se + 1e-12))
    # and the default threshold switches to probes above 1024 test points
    assert gp.mean_std(xt, exact_threshold=100)[1].shape == sd.shape


def test_hutchinson_matches_jax_on_the_same_probes(gp_data, monkeypatch):
    # both packages fed the same Rademacher block: the JAX package's keys
    # become probe indices into it, so its vmapped probe draws the column
    x, y, xt = gp_data
    jg, tg = gp_pair("se", lazy=True)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    Z = np.random.default_rng(4).choice([-1.0, 1.0], (150, 8))
    Zj = jnp.asarray(Z)
    monkeypatch.setattr(jax.random, "split",
                        lambda key, num: jnp.arange(num))
    monkeypatch.setattr(jax.random, "rademacher",
                        lambda k, shape, dtype=None: Zj[:, k])
    want = jg.mean_std(jnp.asarray(xt), probes=8, method="hutchinson")
    monkeypatch.setattr(
        torch, "randint",
        lambda lo, hi, shape, generator=None: torch.as_tensor(
            (Z + 1) / 2, dtype=torch.int64))
    got = tg.mean_std(xt, probes=8, method="hutchinson")
    assert_posterior_close(got, want)


@pytest.mark.parametrize("lazy", [True, False])
def test_sample_pathwise_on_fed_draws_matches_jax(gp_data, lazy,
                                                  monkeypatch):
    """Matheron draws with a CG correction per path and no preconditioner:
    the same RFF embedding (numpy-seeded, identical in both packages) and
    the same normals θ fed to both; each column runs its own recurrence
    (the JAX package's vmap(cg_solve), the port's `_cg_columns`), so the
    paths agree to the solver's rounding, 1e-8 relative at tol 1e-10."""
    from stpy_tpu.embeddings import RFFEmbedding as JaxRFF
    from stpy_tpu_torch.embeddings import RFFEmbedding as TorchRFF

    x, y, xt = gp_data
    jg, tg = gp_pair("se+matern32", lazy=lazy)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    kw = dict(gamma=0.5, m=64, d=3, seed=4)
    je, te = JaxRFF(**kw), TorchRFF(**kw, device="cpu", dtype=torch.float64)
    theta = np.random.default_rng(6).standard_normal((64, 5))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(theta))
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **k: torch.as_tensor(theta))
    got = tg.sample_pathwise(xt, te, size=5)
    want = jg.sample_pathwise(jnp.asarray(xt), je, size=5)
    assert got.shape == (150, 5)
    assert rel_err(got.numpy(), want) <= 1e-8


@pytest.mark.parametrize("precision", ["single", "double"])
def test_load_iterative_state_serves_the_jax_mean(gp_data, precision):
    x, y, xt = gp_data
    jg, tg = gp_pair("se+matern32", lazy=True, precision=precision,
                     var_refine=0)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    A_df = None if jg._A_df is None else np.asarray(jg._A_df)
    load_iterative_state(tg, np.asarray(jg.x), np.asarray(jg.y),
                         np.asarray(jg.A), A_df)
    assert tg.fitted and tg.fit_status is None
    assert rel_err(tg.mean(xt).numpy(), jg.mean(jnp.asarray(xt))) <= 1e-10
    assert_posterior_close(tg.mean_std(xt), jg.mean_std(jnp.asarray(xt)))


def test_model_lives_on_the_kernel_device_and_dtype():
    k = torch_kernel("se")
    gp = tit.IterativeGP(k)
    assert gp.device == torch.device("cpu") and gp.dtype == torch.float64
    with pytest.raises(ValueError, match="disagrees"):
        tit.IterativeGP(k, dtype=torch.float32)
    with pytest.raises(ValueError, match="disagrees"):
        tit.IterativeGP(k, device="meta")


def test_dense_gram_of_the_jax_functions_matches(gp_data):
    # the dense tier's operator is K + s²I of the symmetrised Gram
    x, _, _ = gp_data
    jg, tg = gp_pair("se", lazy=False)
    xj = jnp.asarray(x)
    jmv, _ = jg._matvec_factory(xj)
    tmv, _ = tg._matvec_factory(torch.as_tensor(x))
    v = np.random.default_rng(1).standard_normal(256)
    assert rel_err(tmv(torch.as_tensor(v)).numpy(), jmv(jnp.asarray(v))) <= 1e-12
    K = np.exp(-0.5 * np.asarray(JF.sq_dist(xj / 0.7, xj / 0.7)))
    assert rel_err(tg._matmat(torch.eye(256, dtype=torch.float64)).numpy(),
                   K + S * S * np.eye(256)) <= 1e-12
