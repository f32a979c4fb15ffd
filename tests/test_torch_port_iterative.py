"""Port parity: the CG solvers, preconditioners and IterativeGP of
stpy_tpu_torch/parallel against stpy_tpu/parallel, at small size (n <= 512,
d = 3) on the CPU.

The same numpy data goes through both packages, JAX in x64 and torch in
float64, where every port wrapper runs its plain PyTorch version. In f64
the stagnation window is off in both, so the solvers run the same
iterations and their iterates agree to rounding: 1e-10 relative. The
IterativeGP posterior is held at 1e-8 relative (mean, to its largest entry)
and 1e-6 (std, entry by entry, the variance cancels) with tol = 1e-10. A
preconditioner built from landmark indices the two packages draw
differently (JAX key against torch.Generator) changes the iterates but not
the converged solution, which is compared instead.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.kernels import functions as JF
from stpy_tpu.parallel import iterative as jit_
from stpy_tpu.parallel import lazy_kernel as jlk
from stpy_tpu_torch.convert import load_iterative_state
from stpy_tpu_torch.parallel import iterative as tit
from stpy_tpu_torch.parallel import lazy_kernel as tlk

from test_torch_port_gram import jax_kernel, torch_kernel

RTOL = 1e-10
MEAN_RTOL, STD_RTOL = 1e-8, 1e-6
S = 0.2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CG loops run hundreds of small torch ops; with the suite's workers
    sharing the cores, intra-op threads only wait on each other (this file
    took 867 s of a six-worker run with them, ~80 s alone), so this module
    runs torch on one thread and restores the count afterwards. One thread
    also keeps clear of the first-call fault of torch's CPU `exp`
    (test_torch_port_exact_gp.pinned_torch_state)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def system():
    """An SPD system of 150 unknowns with eigenvalues spread evenly over
    [1, 30], a block of right-hand sides and a diagonal preconditioner, as
    numpy arrays. On an even spectrum CG's rounding does not grow, so the
    two packages run the same iterations; on a kernel Gram's clustered
    spectrum it grows from the first Ritz value that converges, and their
    iterates part after a few dozen steps (compared at convergence below)."""
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((150, 150)))
    A = (Q * np.linspace(1, 30, 150)) @ Q.T
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((150, 6))
    dinv = 1.0 / (np.diag(A) + rng.uniform(0, 0.5, 150))
    return A, B, dinv


def jax_ops(A, dinv):
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    return (lambda v: Aj @ v), (lambda V: Aj @ V), (
        lambda r: dj * r if r.ndim == 1 else dj[:, None] * r)


def torch_ops(A, dinv):
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    return (lambda v: At @ v), (lambda V: At @ V), (
        lambda r: dt * r if r.dim() == 1 else dt[:, None] * r)


@pytest.mark.parametrize("precond", [False, True])
def test_cg_solve_matches_jax(system, precond):
    A, B, dinv = system
    jmv, _, jM = jax_ops(A, dinv)
    tmv, _, tM = torch_ops(A, dinv)
    jx, jits, jres = jit_.cg_solve(jmv, jnp.asarray(B[:, 0]),
                                   M_inv=jM if precond else None, tol=1e-11,
                                   maxiter=400)
    tx, tits, tres = tit.cg_solve(tmv, torch.as_tensor(B[:, 0]),
                                  M_inv=tM if precond else None, tol=1e-11,
                                  maxiter=400)
    assert tits == int(jits) and 0 < tits < 400
    assert rel_err(tx.numpy(), jx) <= RTOL
    assert float(tres) == pytest.approx(float(jres), rel=1e-3)
    assert float(tres) <= 1e-11


def test_cg_solve_stops_at_maxiter_like_jax(system):
    A, B, dinv = system
    jmv, _, _ = jax_ops(A, dinv)
    tmv, _, _ = torch_ops(A, dinv)
    jx, jits, _ = jit_.cg_solve(jmv, jnp.asarray(B[:, 1]), tol=1e-14,
                                maxiter=9)
    tx, tits, _ = tit.cg_solve(tmv, torch.as_tensor(B[:, 1]), tol=1e-14,
                               maxiter=9)
    assert tits == int(jits) == 9
    assert rel_err(tx.numpy(), jx) <= RTOL


@pytest.mark.parametrize("window,stop", [(10, 10), (25, 25), (None, 500)])
def test_stagnation_window_stops_slow_progress_like_jax(window, stop):
    # eigenvalues spread geometrically over [1, 1e4]: ‖r‖² sheds less than
    # half per 10 or 25 steps, so a window of that length stops the solve at
    # its first checkpoint, in both packages; without one both run to maxiter
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((150, 150)))
    A = (Q * np.geomspace(1, 1e4, 150)) @ Q.T
    A = 0.5 * (A + A.T)
    B = rng.standard_normal((150, 6))
    jx, jits, _ = jit_.cg_solve(lambda v: jnp.asarray(A) @ v,
                                jnp.asarray(B[:, 2]), tol=1e-12, maxiter=500,
                                stall_window=window)
    tx, tits, tres = tit.cg_solve(lambda v: torch.as_tensor(A) @ v,
                                  torch.as_tensor(B[:, 2]), tol=1e-12,
                                  maxiter=500, stall_window=window)
    assert tits == int(jits) == stop and float(tres) > 1e-12
    assert rel_err(tx.numpy(), jx) <= 1e-8
    jX, jb = jit_.cg_solve_block(lambda V: jnp.asarray(A) @ V, jnp.asarray(B),
                                 tol=1e-12, maxiter=500, stall_window=window)
    tX, tb = tit.cg_solve_block(lambda V: torch.as_tensor(A) @ V,
                                torch.as_tensor(B), tol=1e-12, maxiter=500,
                                stall_window=window)
    assert tb == int(jb) == stop
    assert rel_err(tX.numpy(), jX) <= 1e-8


def test_auto_window_is_100_in_f32_and_off_in_f64():
    assert tit._auto_window("auto", torch.float32) == 100
    assert tit._auto_window("auto", torch.float64) == 1 << 30
    assert tit._auto_window(None, torch.float32) == 1 << 30
    assert tit._auto_window(7, torch.float64) == 7


@pytest.mark.parametrize("precond", [False, True])
def test_cg_solve_block_matches_jax(system, precond):
    A, B, dinv = system
    _, jmm, jM = jax_ops(A, dinv)
    _, tmm, tM = torch_ops(A, dinv)
    jX, jits = jit_.cg_solve_block(jmm, jnp.asarray(B),
                                   M_inv=jM if precond else None, tol=1e-11,
                                   maxiter=400)
    tX, tits = tit.cg_solve_block(tmm, torch.as_tensor(B),
                                  M_inv=tM if precond else None, tol=1e-11,
                                  maxiter=400)
    assert tits == int(jits) and 0 < tits < 400
    assert rel_err(tX.numpy(), jX) <= RTOL


@pytest.mark.parametrize("segment", [7, 25])
def test_cg_solve_block_segmented_matches_jax(system, segment):
    A, B, dinv = system
    _, jmm, jM = jax_ops(A, dinv)
    _, tmm, tM = torch_ops(A, dinv)
    jX, jits = jit_.cg_solve_block_segmented(
        jmm, jnp.asarray(B), M_inv=jM, tol=1e-11, maxiter=400,
        segment=segment)
    tX, tits = tit.cg_solve_block_segmented(
        tmm, torch.as_tensor(B), M_inv=tM, tol=1e-11, maxiter=400,
        segment=segment)
    assert tits == int(jits) and tits > segment
    assert rel_err(tX.numpy(), jX) <= RTOL


def test_cg_solve_segmented_matches_jax(system):
    A, B, dinv = system
    jmv, _, jM = jax_ops(A, dinv)
    tmv, _, tM = torch_ops(A, dinv)
    jx, jits, jres = jit_.cg_solve_segmented(
        jmv, jnp.asarray(B[:, 3]), M_inv=jM, tol=1e-11, maxiter=300,
        segment=10)
    tx, tits, tres = tit.cg_solve_segmented(
        tmv, torch.as_tensor(B[:, 3]), M_inv=tM, tol=1e-11, maxiter=300,
        segment=10)
    assert tits == int(jits)
    assert rel_err(tx.numpy(), jx) <= RTOL
    assert float(tres) == pytest.approx(float(jres), rel=1e-3)


def test_segmented_solver_returns_the_best_iterate_when_a_segment_stalls():
    # on a kernel Gram with s = 0.2, seven CG steps leave every column's
    # residual NORM above ‖b‖ (CG minimises the A-norm of the error): the
    # segment test stops, and the best iterate seen is the zero start, in
    # both packages
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (150, 3))
    A = np.exp(-0.5 * np.sum((x[:, None] - x[None]) ** 2, -1) / 0.6 ** 2)
    A += S * S * np.eye(150)
    B = rng.standard_normal((150, 6))
    jX, jits = jit_.cg_solve_block_segmented(
        lambda V: jnp.asarray(A) @ V, jnp.asarray(B), tol=1e-9, maxiter=400,
        segment=7)
    tX, tits = tit.cg_solve_block_segmented(
        lambda V: torch.as_tensor(A) @ V, torch.as_tensor(B), tol=1e-9,
        maxiter=400, segment=7)
    assert tits == int(jits) == 7
    assert not np.any(np.asarray(jX)) and not torch.any(tX)


@pytest.fixture(scope="module")
def landmarks():
    """A sum-kernel system at n = 300 with 40 landmark columns from numpy
    indices, the same in both packages."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (300, 3))
    idx = np.sort(rng.choice(300, 40, replace=False))
    R = rng.standard_normal((300, 4))
    return x, idx, R


def _apply_both(jM, tM, R):
    jv, tv = jM(jnp.asarray(R[:, 0])), tM(torch.as_tensor(R[:, 0]))
    jB, tB = jM(jnp.asarray(R)), tM(torch.as_tensor(R))
    assert tv.shape == (R.shape[0],) and tB.shape == R.shape
    return max(rel_err(tv.numpy(), jv), rel_err(tB.numpy(), jB))


def test_rayleigh_nystrom_precond_matches_jax(landmarks):
    x, idx, R = landmarks
    jk, tk = jax_kernel("se+matern32"), torch_kernel("se+matern32")
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    jC = jk.cross(xj, xj[idx])
    tC = tk.cross(xt, xt[idx])
    assert rel_err(tC.numpy(), jC) <= 1e-12
    jatoms, tatoms = jlk.fast_atoms(jk), tlk.fast_atoms(tk)
    assert [(a.family, a.nu, a.gamma_key, a.group) for a in tatoms] == \
        [(a.family, a.nu, a.gamma_key, a.group) for a in jatoms]
    jg = [jlk.atom_params(jk, a) for a in jatoms]
    tg = [tlk.atom_params(tk, a) for a in tatoms]
    jmm = jlk.make_sum_matmat(xj, jatoms, [g for g, _ in jg],
                              [k for _, k in jg], noise=S)
    tmm = tlk.make_sum_matmat(xt, tatoms, [g for g, _ in tg],
                              [k for _, k in tg], noise=S)
    jM = jit_.rayleigh_nystrom_precond(jC, jmm, S, block=16)
    tM = tit.rayleigh_nystrom_precond(tC, tmm, S, block=16)
    assert _apply_both(jM, tM, R) <= 1e-9


def test_nystrom_and_lowrank_preconds_match_jax(landmarks):
    x, idx, R = landmarks
    jk, tk = jax_kernel("se"), torch_kernel("se")
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    jC, tC = jk.cross(xj, xj[idx]), tk.cross(xt, xt[idx])
    jM = jit_.nystrom_precond_from_cross(jC, jnp.asarray(idx), S)
    tM = tit.nystrom_precond_from_cross(tC, torch.as_tensor(idx), S)
    assert _apply_both(jM, tM, R) <= 1e-9
    jL = jit_.lowrank_eigen_precond(jC, S)
    tL = tit.lowrank_eigen_precond(tC, S)
    assert _apply_both(jL, tL, R) <= 1e-9


def test_pivoted_cholesky_precond_matches_jax(landmarks):
    x, _, R = landmarks
    jk, tk = jax_kernel("matern52"), torch_kernel("matern52")
    jLm = jit_.pivoted_cholesky_kernel(jk, jnp.asarray(x), 25)
    tLm = tit.pivoted_cholesky_kernel(tk, torch.as_tensor(x), 25)
    assert tLm.shape == (25, 300)
    assert rel_err(tLm.numpy(), jLm) <= 1e-10
    jM = jit_.make_pivchol_precond(jLm, S)
    tM = tit.make_pivchol_precond(tLm, S)
    assert _apply_both(jM, tM, R) <= 1e-9


def test_eigenform_deflation_cap_keeps_the_apply_positive():
    # σ² far below λ: the exact coefficient would be 1 − 1e-16; the cap
    # 1 − 256·eps keeps the deflated direction at a positive margin
    U = torch.eye(4, dtype=torch.float64)[:, :2]
    lam = torch.tensor([1e12, 1.0], dtype=torch.float64)
    M = tit._eigenform_apply(U, lam, 1e-3)
    out = M(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))
    eps = torch.finfo(torch.float64).eps
    assert float(out[0]) == pytest.approx(256 * eps / 1e-6, rel=1e-6)


def test_small_eigh_runs_in_float64_and_returns_the_input_dtype():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((40, 40))
    A32 = torch.as_tensor(A + A.T, dtype=torch.float32)
    lam, V = tit._eigh64(A32)
    lam64, V64 = torch.linalg.eigh(A32.double())
    assert lam.dtype == V.dtype == torch.float32
    assert torch.equal(lam, lam64.float()) and torch.equal(V, V64.float())
    # rounded from float64, V is orthonormal to a few f32 ulps
    I = torch.eye(40, dtype=torch.float64)
    assert float((V.double().T @ V.double() - I).abs().max()) <= 1e-6


def test_resolve_precond_rank_matches_jax():
    for rank, n in (("auto", 512), ("auto", 16384), ("auto", 16385),
                    (64, 100), (0, 70000)):
        assert tit.resolve_precond_rank(rank, n) == \
            jit_.resolve_precond_rank(rank, n)


@pytest.fixture(scope="module")
def gp_data():
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (256, 3))
    y = np.sin(3 * x[:, :1]) + 0.1 * rng.standard_normal((256, 1))
    xt = rng.uniform(-1, 1, (150, 3))
    return x, y, xt


def gp_pair(case, **kw):
    kw = {"s": S, "tol": 1e-10, "maxiter": 600, **kw}
    return (jit_.IterativeGP(jax_kernel(case), **kw),
            tit.IterativeGP(torch_kernel(case), **kw))


def assert_posterior_close(got, want, mean_rtol=MEAN_RTOL, std_rtol=STD_RTOL):
    (tm, ts), (jm, js) = got, want
    tm, ts, jm, js = tm.numpy(), ts.numpy(), np.asarray(jm), np.asarray(js)
    assert tm.shape == jm.shape and ts.shape == js.shape
    assert rel_err(tm, jm) <= mean_rtol
    assert np.max(np.abs(ts - js) / js) <= std_rtol


# the fast tier (sums of fused atoms) and the row-chunked general tier
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


def test_unported_paths_raise_naming_the_roadmap(gp_data):
    x, y, xt = gp_data
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tit.IterativeGP(torch_kernel("se"), mesh=object())
    gp = tit.IterativeGP(torch_kernel("se"), s=S, lazy=True,
                         precision="double")
    gp.fit_gp(x, y)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        gp.mean_std(xt)
    with pytest.raises(NotImplementedError, match="Queue 1 items 5 and 11"):
        gp.optimize_params()
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        gp.sample_pathwise(xt, None)


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
    # the fit and the exact variance take the segmented solvers above the
    # threshold, as in the JAX package; the threshold is lowered here
    x, y, xt = gp_data
    calls = []
    for name in ("cg_solve_segmented", "cg_solve_block_segmented"):
        real = getattr(tit, name)
        monkeypatch.setattr(
            tit, name,
            lambda *a, _real=real, _name=name, **k: calls.append(_name)
            or _real(*a, **k))
    monkeypatch.setattr(tit, "SEGMENT_ABOVE", 200)
    gp = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    gp.fit_gp(x, y)
    gp.mean_std(xt)
    # the fit's single-RHS adapter runs the block solver inside, then the
    # variance runs it once per 128-column block of the 150 test points
    assert calls == ["cg_solve_segmented"] + ["cg_solve_block_segmented"] * 3
    ref = tit.IterativeGP(torch_kernel("se"), s=S, tol=1e-10, lazy=True)
    monkeypatch.setattr(tit, "SEGMENT_ABOVE", 32768)
    ref.fit_gp(x, y)
    assert rel_err(gp.mean(xt).numpy(), ref.mean(xt).numpy()) <= 1e-8


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
