"""Port parity: stpy_tpu_torch/domains.py and point_processes/poisson.py
against stpy_tpu on the CPU.

The same boxes, balls, grids and rate functions go through both packages,
JAX in x64 and torch in float64: the geometry, the discretizations, the
Gauss-Legendre rules, the hierarchy's set order (`get_sets_level`), the
membership masks and the rate integrals agree to 1e-10 relative. The
samplers draw from a `torch.Generator` where the JAX package takes a key,
so their draws are held by what they must satisfy: the points lie in the
set (and on its grid for the discretized sampler), and the counts follow
the rate's integral.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import domains as jd
from stpy_tpu.point_processes import PoissonPointProcess as JaxProcess
from stpy_tpu_torch import domains as td
from stpy_tpu_torch.point_processes import PoissonPointProcess as TorchProcess
from stpy_tpu_torch.point_processes import SeasonalPoissonPointProcess

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


BOXES = [(1, [[-1.0, 0.5]]), (2, [[-1.0, 1.0], [-0.5, 0.25]]),
         (3, [[0.0, 1.0], [-1.0, 1.0], [0.2, 0.7]])]


@pytest.mark.parametrize("d,bounds", BOXES)
def test_box_geometry_and_discretizations_match_jax(d, bounds):
    J, T = jd.BorelSet(d, bounds), td.BorelSet(d, bounds, **F64)
    assert T.volume() == pytest.approx(J.volume(), rel=1e-15)
    assert T.perimeter() == pytest.approx(J.perimeter(), rel=1e-15)
    assert rel(T.center_point(), J.center_point()) < RTOL
    assert rel(T.return_discretization(5), J.return_discretization(5)) < RTOL
    offsets = [0.1] * d
    assert rel(T.return_discretization(4, offsets),
               J.return_discretization(4, offsets)) < RTOL
    (wj, nj), (wt, nt) = (J.return_legendre_discretization(6),
                          T.return_legendre_discretization(6))
    assert rel(wt, wj) < RTOL and rel(nt, nj) < RTOL
    x = np.random.default_rng(d).uniform(-1.2, 1.2, (200, d))
    assert np.array_equal(T.is_inside(torch.tensor(x)).numpy(),
                          np.asarray(J.is_inside(jnp.asarray(x))))


def test_inside_relations_match_jax():
    a, b, c = [[-1.0, 1.0], [-1.0, 1.0]], [[-0.5, 0.5], [0.0, 1.0]], \
        [[-0.5, 1.5], [0.0, 1.0]]
    Jb = [jd.BorelSet(2, x) for x in (a, b, c)]
    Tb = [td.BorelSet(2, x, **F64) for x in (a, b, c)]
    Jball = jd.BallSet(2, [0.1, 0.2], 1.0)
    Tball = td.BallSet(2, [0.1, 0.2], 1.0, **F64)
    Jsmall = jd.BallSet(2, [0.2, 0.2], 0.3)
    Tsmall = td.BallSet(2, [0.2, 0.2], 0.3, **F64)
    for i in range(3):
        for j in range(3):
            assert Tb[i].inside(Tb[j]) == Jb[i].inside(Jb[j])
        assert Tball.inside(Tb[i]) == Jball.inside(Jb[i])
    assert Tball.inside(Tsmall) == Jball.inside(Jsmall)


@pytest.mark.parametrize("d", [1, 2])
def test_ball_quadrature_and_membership_match_jax(d):
    center = [0.1, -0.2][:d]
    J, T = jd.BallSet(d, center, 0.7), td.BallSet(d, center, 0.7, **F64)
    assert T.volume() == pytest.approx(J.volume(), rel=1e-15)
    assert rel(T.bounds, J.bounds) < RTOL
    (wj, nj), (wt, nt) = (J.return_legendre_discretization(7),
                          T.return_legendre_discretization(7))
    assert rel(wt, wj) < RTOL and rel(nt, nj) < RTOL
    assert rel(T.return_discretization(5), J.return_discretization(5)) < RTOL
    x = np.random.default_rng(3).uniform(-1, 1, (300, d))
    assert np.array_equal(T.is_inside(torch.tensor(x)).numpy(),
                          np.asarray(J.is_inside(jnp.asarray(x))))


@pytest.mark.parametrize("d,levels", [(1, 4), (2, 3), (3, 2)])
def test_hierarchy_sets_and_their_order_match_jax(d, levels):
    interval = [[-1.0, 1.0]] * d
    J = jd.HierarchicalBorelSets(d, interval, levels)
    T = td.HierarchicalBorelSets(d, interval, levels, **F64)
    assert len(T.get_all_sets()) == len(J.get_all_sets())
    for lev in range(1, levels + 1):
        js, ts = J.get_sets_level(lev), T.get_sets_level(lev)
        assert len(ts) == len(js) == 2 ** (d * (lev - 1))
        assert rel(np.stack([t.bounds.numpy() for t in ts]),
                   np.stack([np.asarray(s.bounds) for s in js])) < RTOL
        assert [t.level for t in ts] == [s.level for s in js]
    assert len(T.get_leafs()) == len(J.get_leafs())
    assert T.get_parent_set() is T.top_node
    if d == 1:
        assert T.top_node.left is T.top_node.children[0]
    cov_j, cov_t = J.get_ball_coverings(3), T.get_ball_coverings(3)
    assert rel(np.stack([c.center.numpy() for c in cov_t]),
               np.stack([np.asarray(c.center) for c in cov_j])) < RTOL
    assert cov_t[0].radius == cov_j[0].radius


def test_candidate_sets_match_jax():
    pts = np.random.default_rng(0).integers(0, 3, (12, 2)).astype(float)
    J, T = jd.CandidateDiscreteSet(pts), td.CandidateDiscreteSet(pts, **F64)
    assert T.size() == J.size() and T.d == J.d
    for a, b in zip(T.get_options_per_dim(), J.get_options_per_dim()):
        assert np.array_equal(a, b)
    J.remove([1, 4]), T.remove([1, 4])
    assert rel(T.get_active_points(), J.get_active_points()) < RTOL
    assert rel(T.get_points(), J.get_points()) < RTOL


@pytest.mark.parametrize("ball", [False, True])
def test_uniform_sample_lies_in_the_set_and_is_uniform(ball):
    S = (td.BallSet(2, [0.3, -0.1], 0.5, **F64) if ball
         else td.BorelSet(2, [[-1.0, 0.0], [0.5, 2.0]], **F64))
    g = torch.Generator().manual_seed(0)
    x = S.uniform_sample(g, 20000)
    assert x.shape == (20000, 2) and x.dtype == torch.float64
    assert bool(S.is_inside(x).all())
    # the mean is the center; for the ball, E‖x − c‖² = R²/2
    assert rel(x.mean(0), S.center if ball else S.center_point()) < 2e-2
    if ball:
        r2 = ((x - S.center) ** 2).sum(1).mean()
        assert float(r2) == pytest.approx(0.5 * 0.25, rel=2e-2)


def _rates():
    def jr(x, dt=1.0):
        return (2.5 * jnp.exp(-jnp.sum(x**2, axis=1, keepdims=True) * 2)
                + 0.3) * dt

    def tr(x, dt=1.0):
        return (2.5 * torch.exp(-torch.sum(x**2, dim=1, keepdim=True) * 2)
                + 0.3) * dt
    return jr, tr


@pytest.mark.parametrize("default_rate", [True, False])
def test_rate_and_rate_volume_match_jax(default_rate):
    if default_rate:
        d, J_kw, T_kw = 1, {}, {}
        JS = jd.BorelSet(1, [[-1.0, 0.7]])
        TS = td.BorelSet(1, [[-1.0, 0.7]], **F64)
    else:
        jr, tr = _rates()
        d, J_kw, T_kw = 2, dict(rate=jr), dict(rate=tr)
        JS = jd.BorelSet(2, [[-1.0, 1.0], [-0.5, 1.0]])
        TS = td.BorelSet(2, [[-1.0, 1.0], [-0.5, 1.0]], **F64)
    J = JaxProcess(d=d, B=3.0, b=0.2, **J_kw)
    T = TorchProcess(d=d, B=3.0, b=0.2, **T_kw)
    x = np.random.default_rng(1).uniform(-1, 1, (50, d))
    assert rel(T.rate(torch.tensor(x), 2.0), J.rate(jnp.asarray(x), 2.0)) < RTOL
    assert T.rate_volume(TS, dt=3.0) == pytest.approx(
        J.rate_volume(JS, dt=3.0), rel=RTOL)
    assert T.rate_sets([TS, TS]) == pytest.approx(J.rate_sets([JS, JS]),
                                                  rel=RTOL)


def test_discretized_sampler_draws_grid_points_at_the_rate():
    _, tr = _rates()
    P = TorchProcess(d=2, B=3.0, rate=tr)
    S = td.BorelSet(2, [[-1.0, 0.0], [-1.0, 0.0]], **F64)
    g = torch.Generator().manual_seed(0)
    grid = S.return_discretization(16)
    counts, hits = [], torch.zeros(grid.shape[0], dtype=torch.float64)
    for _ in range(200):
        x = P.sample_discretized(g, S, 20.0, n=16)
        counts.append(0 if x is None else x.shape[0])
        if x is not None:
            eq = (x[:, None, :] == grid[None, :, :]).all(-1)
            assert bool(eq.any(1).all())     # every point is a grid node
            hits += eq.double().sum(0)
    lam = P.rate_volume(S, 20.0)
    # Poisson counts: the mean within 5 standard errors of λ
    assert abs(np.mean(counts) - lam) < 5 * np.sqrt(lam / len(counts))
    # the points spread over the grid ∝ λ: Pearson's χ² within 5 standard
    # deviations (√(2k)) of its k = 255 degrees of freedom
    p = tr(grid).reshape(-1)
    expect = hits.sum() * p / p.sum()
    k = grid.shape[0] - 1
    assert float(((hits - expect) ** 2 / expect).sum()) < k + 5 * np.sqrt(2 * k)


def test_thinning_sampler_and_the_seasonal_process():
    _, tr = _rates()
    P = TorchProcess(d=2, B=3.0, b=0.0, rate=tr)
    P.exact = False
    S = td.BorelSet(2, [[0.0, 1.0], [0.0, 1.0]], **F64)
    g = torch.Generator().manual_seed(1)
    n = [0 if (x := P.sample(g, S, dt=5.0)) is None else x.shape[0]
         for _ in range(200)]
    lam = P.rate_volume(S, 5.0)
    assert abs(np.mean(n) - lam) < 5 * np.sqrt(lam / len(n))
    Q = SeasonalPoissonPointProcess(d=2, B=3.0, rate=tr)
    x = torch.tensor([[0.1, 0.2]], dtype=torch.float64)
    assert float(Q.rate_at_time(x, 0.25)) == pytest.approx(
        1.5 * float(tr(x)), rel=1e-14)
    rate = Q.rate
    out = Q.sample_at_time(g, S, 0.25, dt=1.0)
    assert out is None or bool(S.is_inside(out).all())
    assert Q.rate is rate      # the modulation is taken off again
