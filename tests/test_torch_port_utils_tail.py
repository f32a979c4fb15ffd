"""Port parity: stpy_tpu_torch/utils/{helper, sampling, transforms,
coresets, colors, metrics}.py against stpy_tpu/utils on the CPU, JAX in
x64 and torch in float64, the same numpy inputs from a seed.

The deterministic helpers (grids, the Halton and van der Corput
sequences, the seeded numpy samplers and splits, the Haar and Haar-Fisz
transforms, the ε-net, the palette) are held equal; the float64 ones
(symsqrt, the affine transform, the R² score, the batched derivatives,
the greedy coreset's variances) within 1e-10 relative; the finite
differences within 1e-8 (the two packages round f's sums apart, and the
quotient divides that by 2ε). The generator-driven draws are held by
their statistics, as tests/test_aux_components.py holds the JAX ones.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.domains import BorelSet as JBorel
from stpy_tpu.kernels import KernelFunction as JKernel
from stpy_tpu.utils import coresets as jc
from stpy_tpu.utils import colors as jcol
from stpy_tpu.utils import helper as jh
from stpy_tpu.utils import metrics as jm
from stpy_tpu.utils import sampling as js
from stpy_tpu.utils import transforms as jt
from stpy_tpu_torch import KernelFunction as TKernel
from stpy_tpu_torch.domains import BorelSet as TBorel
from stpy_tpu_torch.utils import coresets as tc
from stpy_tpu_torch.utils import colors as tcol
from stpy_tpu_torch.utils import helper as th
from stpy_tpu_torch.utils import metrics as tm
from stpy_tpu_torch.utils import sampling as ts
from stpy_tpu_torch.utils import transforms as tt

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def test_grids_equal_jax():
    arrays = [np.arange(3), np.linspace(0, 1, 4), [-1.0, 2.0]]
    np.testing.assert_array_equal(th.cartesian(arrays), jh.cartesian(arrays))
    np.testing.assert_array_equal(
        th.interval(5, 2, L_infinity_ball=0.5, offset=[0.1, -0.2], **F64),
        jh.interval(5, 2, L_infinity_ball=0.5, offset=[0.1, -0.2]))
    bounds = [[-1, 0.5], [0, 2], [3, 4]]
    np.testing.assert_array_equal(th.interval_grid(4, 3, bounds, **F64),
                                  jh.interval_grid(4, 3, bounds))
    assert th.interval(5, 2, device="cpu").dtype == torch.float32


def test_symsqrt_and_logdet_match_jax():
    rng = np.random.default_rng(0)
    G = rng.standard_normal((12, 12))
    A = G @ G.T + 0.1 * np.eye(12)
    S = th.symsqrt(torch.as_tensor(A))
    assert rel(S, jh.symsqrt(jnp.asarray(A))) < RTOL
    assert rel(S @ S, A) < RTOL
    L = np.linalg.cholesky(A)
    assert float(th.logdet(torch.as_tensor(L))) == pytest.approx(
        float(jh.logdet(jnp.asarray(L))), rel=RTOL)


def test_gradient_helpers_match_jax():
    x = np.array([0.3, -1.2, 0.7])
    want = np.array([3 * 0.09 + np.cos(0.3) * -1.2, 3 * 1.44 + np.sin(0.3),
                     3 * 0.49])

    def fn(x, sin):
        return (x**3).sum() + sin(x[0]) * x[1]

    g_j = jh.finite_difference_gradient(lambda v: fn(v, np.sin), x)
    g_t = th.finite_difference_gradient(lambda v: fn(v, torch.sin), x)
    assert rel(g_t, g_j) < 1e-8 and rel(g_t, want) < 1e-8
    c_j = jh.complex_step_gradient(lambda v: fn(v, np.sin), x)
    c_t = th.complex_step_gradient(lambda v: fn(v, torch.sin), x)
    assert rel(c_t, c_j) < RTOL and rel(c_t, want) < RTOL


def test_batch_jacobian_and_hessian_match_jax():
    X = np.random.default_rng(1).uniform(-1, 1, (6, 2))

    def vec(x, m):
        return m.stack([m.sin(x[0]) * x[1], x[0] ** 2 + m.exp(x[1])])

    def scalar(x, m):
        return m.sin(x[0]) * x[1] ** 2 + m.exp(x[0] * x[1])

    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    Jj = jax.jit(lambda a: jh.batch_jacobian(lambda x: vec(x, jnp), a))(Xj)
    Hj = jax.jit(lambda a: jh.batch_hessian(lambda x: scalar(x, jnp), a))(Xj)
    assert rel(th.batch_jacobian(lambda x: vec(x, torch), Xt), Jj) < RTOL
    assert rel(th.batch_hessian(lambda x: scalar(x, torch), Xt), Hj) < RTOL


def test_halton_rejection_and_splits_equal_jax():
    np.testing.assert_array_equal(ts.vdc(50, 3), js.vdc(50, 3))
    np.testing.assert_array_equal(ts.halton_sequence(100, 4),
                                  js.halton_sequence(100, 4))
    inv = (lambda u: 2 * u - 1)
    np.testing.assert_array_equal(ts.sample_qmc_halton(inv, (30, 2)),
                                  js.sample_qmc_halton(inv, (30, 2)))

    def pdf(x):
        return np.exp(-0.5 * np.sum(x**2, axis=1))

    np.testing.assert_array_equal(
        ts.rejection_sampling(pdf, (200, 2), proposal_range=3.0, seed=4),
        js.rejection_sampling(pdf, (200, 2), proposal_range=3.0, seed=4))
    x = np.random.default_rng(2).integers(0, 7, (40, 2)).astype(float)
    for a, b in zip(ts.randomly_split_set_without_duplicates(x, [10, 12, 9],
                                                             seed=3),
                    js.randomly_split_set_without_duplicates(x, [10, 12, 9],
                                                             seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(
            ts.randomly_split_set_without_duplicates_balanced(
                torch.as_tensor(x), 3, seed=5),
            js.randomly_split_set_without_duplicates_balanced(x, 3, seed=5)):
        np.testing.assert_array_equal(a, b)


def test_generator_draws_by_their_statistics():
    g = torch.Generator().manual_seed(0)
    n = 20000
    z = ts.sample_uniform_sphere(g, n, 3, radius=2.0, dtype=torch.float64)
    assert z.shape == (n, 3)
    assert float((torch.linalg.vector_norm(z, dim=1) - 2.0).abs().max()) \
        < 1e-12
    # uniform on the sphere: mean 0, second moment r²/d per coordinate
    assert float(z.mean(0).abs().max()) < 4 * 2.0 / np.sqrt(3 * n)
    assert rel((z**2).mean(0), np.full(3, 4.0 / 3)) < 0.05
    bounds = [[-1.0, 3.0], [0.5, 1.0]]
    u = ts.sample_bounded(g, bounds, n=n, dtype=torch.float64)
    lo, hi = u.min(0).values.numpy(), u.max(0).values.numpy()
    assert (lo >= [-1.0, 0.5]).all() and (hi <= [3.0, 1.0]).all()
    # the JAX package's draws have the same moments
    uj = np.asarray(js.sample_bounded(jax.random.PRNGKey(0), bounds, n=n))
    widths = np.array([4.0, 0.5])
    assert np.all(np.abs(u.mean(0).numpy() - uj.mean(0))
                  < 8 * widths / np.sqrt(12 * n))


def test_transform_and_r_score_match_jax():
    X = np.random.default_rng(8).uniform(2, 5, (20, 2))
    Xt, fwd, inv = tt.transform(X, low=-1, high=1, offsets=[0.1, 0.2], **F64)
    Xj, fwd_j, inv_j = jt.transform(X, low=-1, high=1, offsets=[0.1, 0.2])
    assert rel(Xt, Xj) < RTOL
    Z = np.random.default_rng(9).uniform(-1, 1, (5, 2))
    assert rel(inv(Z), inv_j(Z)) < RTOL and rel(fwd(Z), fwd_j(Z)) < RTOL
    assert rel(inv(Xt), X) < RTOL
    assert rel(tt.transform(X, functions=False, **F64),
               jt.transform(X, functions=False)) < RTOL
    rng = np.random.default_rng(10)
    y, yp, sd = (rng.standard_normal(30) for _ in range(3))
    assert tt.r_score_std(y, yp, sd, alpha=0.5, **F64) == pytest.approx(
        jt.r_score_std(y, yp, sd, alpha=0.5), rel=RTOL)


def test_haar_and_fisz_transforms_equal_jax():
    def f(x):
        return np.sin(3 * x[:, 0]) + x[:, 0] ** 2

    sc_t, det_t = tt.haar_coefficients(f, (-1, 1), 5)
    sc_j, det_j = jt.haar_coefficients(f, (-1, 1), 5)
    assert sc_t == sc_j
    for a, b in zip(det_t, det_j):
        np.testing.assert_array_equal(a, b)
    xs = np.linspace(-1, 1, 37)
    np.testing.assert_array_equal(tt.haarval(sc_t, det_t, xs, (-1, 1)),
                                  jt.haarval(sc_j, det_j, xs, (-1, 1)))
    data = np.random.default_rng(9).poisson(5.0, 64).astype(float)
    tr = tt.haar_fisz_transform(data)
    np.testing.assert_array_equal(tr, jt.haar_fisz_transform(data))
    np.testing.assert_array_equal(tt.inverse_haar_fisz_transform(tr),
                                  jt.inverse_haar_fisz_transform(tr))
    assert np.allclose(tt.inverse_haar_fisz_transform(tr), data, atol=1e-8)


def test_coresets_match_jax():
    jb = JBorel(2, np.array([[-1.0, 1.0], [-1.0, 1.0]]))
    tb = TBorel(2, np.array([[-1.0, 1.0], [-1.0, 1.0]]), **F64)
    np.testing.assert_array_equal(tc.epsilon_net(tb, 5), jc.epsilon_net(jb, 5))
    np.testing.assert_array_equal(tc.coreset(tb, 4), jc.coreset(jb, 4))
    jk = JKernel(kernel_name="squared_exponential", gamma=0.4, d=2)
    tk = TKernel(kernel_name="squared_exponential", gamma=0.4, d=2, **F64)
    # the JAX loop compiles each step's shapes anew: 3 picks
    got = tc.coreset_leverage_score_greedy(tb, tk, 3, grid=16)
    want = jc.coreset_leverage_score_greedy(jb, jk, 3, grid=16)
    np.testing.assert_array_equal(got, want)
    # the tolerance stops the greedy sequence early
    early = tc.coreset_leverage_score_greedy(tb, tk, 50, tol=0.5, grid=16)
    assert 3 < early.shape[0] < 50
    np.testing.assert_array_equal(early[:3], got)


def test_colors_equal_jax():
    assert tcol.find_byname("Teal") == jcol.find_byname("Teal")
    assert tcol.rrggbb_to_triplet("#0d9488") == jcol.rrggbb_to_triplet(
        "#0d9488")
    assert tcol.triplet_to_rrggbb((1, 2, 3)) == jcol.triplet_to_rrggbb(
        (1, 2, 3))
    assert tcol.cycle(15) == jcol.cycle(15)


def test_metrics_match_jax(tmp_path):
    kw = dict(name="fit", wall_time_s=1.25, compile_time_s=0.5,
              iterations=7, nll=3.5, extra={"n": 16})
    assert tm.FitMetrics(**kw).as_dict() == jm.FitMetrics(**kw).as_dict()
    m = tm.FitMetrics(name="demo")
    with tm.timed(m):
        sum(range(1000))
    assert m.wall_time_s > 0.0
    A = torch.randn(64, 64, dtype=torch.float64)
    first, median = tm.time_jitted(lambda a: a @ a, A, reps=3)
    assert first > 0.0 and median > 0.0
    path = tmp_path / "trace.json"
    with tm.trace(path):
        (A @ A).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert tm.flops_achieved(10, 2.0) == jm.flops_achieved(10, 2.0)
    assert tm.flops_achieved(10, 0.0) == jm.flops_achieved(10, 0.0)
