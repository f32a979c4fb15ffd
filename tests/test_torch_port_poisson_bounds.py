"""Port parity: the confidence machinery of `PoissonRateEstimator` against
stpy_tpu on the CPU, on the JAX fit's state.

Both packages load the same rounds (tests/test_torch_port_poisson.py's
1-D hierarchy, JAX in x64, torch in float64); JAX fits its count-record
MAP, and `convert.load_rate_estimator_state` carries the fitted rate into
the port, so that nothing below depends on an L-BFGS path. The Laplace,
regression and bins covariances, the ellipsoid approximation (W⁺, the
pointwise and per-set bands, β's theory value), the acquisitions, the
batched `ucb_lcb_actions` and the per-action `ucb`/`lcb`, and the
likelihood-ratio bounds agree to 1e-6 relative. The conformal sets refit
for every hypothesised count and draw its synthetic points: both packages
are given the same deterministic refit (a ridge on the current rounds)
and the same points, and their (map, ucb, lcb) agree to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import domains as jd
from stpy_tpu_torch import domains as td
from stpy_tpu_torch.convert import load_rate_estimator_state

from test_torch_port_poisson import LEVELS, make_pair, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

RTOL = 1e-6


@pytest.fixture(scope="module")
def fitted():
    J, T, jh, th = make_pair(uncertainty="laplace")
    J.fit_gp()
    load_rate_estimator_state(T, rate=np.asarray(J.rate))
    return J, T, jh, th


def test_loader_carries_the_rate_and_data(fitted):
    J, T, *_ = fitted
    assert rel(T.rate, J.rate) < 1e-15
    _, T2, *_ = make_pair()
    load_rate_estimator_state(T2, rate=J.rate, phis=J.phis, counts=J.counts,
                              observations=J.observations,
                              obs_multiplicities=J.obs_multiplicities,
                              W=np.eye(16), loglikelihood=1.5)
    assert rel(T2.phis, J.phis) < 1e-15 and T2.loglikelihood == 1.5
    assert rel(T2.W, np.eye(16)) == 0


@pytest.mark.parametrize("kind", ["laplace", "regression", "bins"])
def test_covariances_match_jax(fitted, kind):
    J, T, *_ = fitted
    name = f"construct_covariance_matrix_{kind}"
    assert rel(getattr(T, name)(), getattr(J, name)()) < RTOL


def test_ellipsoid_approximation_and_bands_match_jax(fitted):
    J, T, jh, th = fitted
    for E in (J, T):
        E.approx, E.approx_fit = "ellipsoid", False
    Sj, St = jh.get_sets_level(LEVELS)[1], th.get_sets_level(LEVELS)[1]
    assert T.ucb(St) == pytest.approx(J.ucb(Sj), rel=RTOL)
    assert T.lcb(St) == pytest.approx(J.lcb(Sj), rel=RTOL)
    assert rel(T.W_inv_approx, J.W_inv_approx) < RTOL
    for a, b in zip(T.map_lcb_ucb_approx_action(St, dt=2.0),
                    J.map_lcb_ucb_approx_action(Sj, dt=2.0)):
        assert rel(a, b) < RTOL
    for a, b in zip(T.map_lcb_ucb(th.top_node, 9),
                    J.map_lcb_ucb(jh.top_node, 9)):
        assert rel(a, b) < RTOL
    assert T.beta_theory() == pytest.approx(J.beta_theory(), rel=RTOL)
    for E in (J, T):
        E.approx_fit = False
    assert T.beta_theory() == pytest.approx(J.beta_theory(), rel=RTOL)
    # the acquisitions on the ellipsoid route
    js, ts = jh.get_sets_level(LEVELS), th.get_sets_level(LEVELS)
    w = lambda S: float(S.volume())          # noqa: E731
    assert T.gap(ts[2], ts, w, 1.0) == pytest.approx(
        J.gap(js[2], js, w, 1.0), rel=RTOL)
    assert T.ucb_action is ts[[id(a) for a in js].index(id(J.ucb_action))]
    assert T.information(ts[0], 1.0) == pytest.approx(
        J.information(js[0], 1.0), rel=RTOL)
    for E in (J, T):
        E.approx, E.approx_fit = None, False


def test_batched_and_per_action_bounds_match_jax(fitted):
    J, T, jh, th = fitted
    js = jh.get_sets_level(LEVELS) + jh.get_sets_level(LEVELS - 1)
    ts = th.get_sets_level(LEVELS) + th.get_sets_level(LEVELS - 1)
    mj, uj, lj = J.ucb_lcb_actions(js)
    mt, ut, lt = T.ucb_lcb_actions(ts)
    for a, b in ((mt, mj), (ut, uj), (lt, lj)):
        assert rel(a, b) < RTOL
    assert bool((lt <= mt + 1e-9).all() and (mt <= ut + 1e-9).all())
    # the scalar route of one action: the batched solve's row
    T.approx_fit = False
    assert T.ucb(ts[1]) == pytest.approx(float(ut[1]), rel=1e-12)
    assert T.lcb(ts[1]) == pytest.approx(float(lt[1]), rel=1e-12)
    # without data: the trivial bounds
    _, T0, _, th0 = make_pair(data=False)
    m0, u0, l0 = T0.ucb_lcb_actions(th0.get_sets_level(LEVELS))
    assert rel(u0, [T0.B * S.volume() for S in th0.get_sets_level(LEVELS)]) == 0
    assert T0.ucb(th0.top_node) == T0.B * 2.0
    assert T0.lcb(th0.top_node) == 0.0


def test_likelihood_ratio_bounds_match_jax(fitted):
    J, T, jh, th = fitted
    Sj, St = jh.get_sets_level(LEVELS)[2], th.get_sets_level(LEVELS)[2]
    for a, b in zip(T.mean_var_ratio_set(St, 1.0), J.mean_var_ratio_set(Sj,
                                                                        1.0)):
        assert rel(a, b) < RTOL
    for a, b in zip(T.map_lcb_ucb_likelihood_ratio(St, 2),
                    J.map_lcb_ucb_likelihood_ratio(Sj, 2)):
        assert rel(a, b) < RTOL


def _ridge(E, xp):
    """A deterministic refit shared by both packages: the ridge
    (PᵀP + I)⁻¹Pᵀc on the current rounds."""
    def refit(*_args, **_kw):
        P, c = np.array(E.phis, float), np.array(E.counts, float)
        theta = np.linalg.solve(P.T @ P + np.eye(P.shape[1]), P.T @ c)
        E.rate = xp(theta)
        return E.rate
    return refit


def test_conformal_sets_match_jax_on_a_shared_refit(fitted, monkeypatch):
    J, T, jh, th = fitted
    points = np.random.default_rng(9).uniform(size=(64, 1))

    def feed(cls):
        def draw(self, _key, n):
            lo, hi = self._bounds_np[0]
            return lo + (hi - lo) * points[:n]
        return draw

    monkeypatch.setattr(jd.BorelSet, "uniform_sample", lambda self, k, n: (
        jnp.asarray(feed(None)(self, k, n))))
    monkeypatch.setattr(td.BorelSet, "uniform_sample", lambda self, g, n: (
        torch.as_tensor(feed(None)(self, g, n), dtype=torch.float64)))
    rate0 = J.rate
    for E, xp in ((J, jnp.asarray),
                  (T, lambda a: torch.as_tensor(a, dtype=torch.float64))):
        monkeypatch.setattr(E, "fit_gp", _ridge(E, xp))
        monkeypatch.setattr(E, "penalized_likelihood_fast", _ridge(E, xp))
    Sj, St = jh.get_sets_level(LEVELS)[1], th.get_sets_level(LEVELS)[1]
    got = T.conformal_confidence_set(St, delta=0.5, max_val=20, dt=4.0)
    want = J.conformal_confidence_set(Sj, delta=0.5, max_val=20, dt=4.0)
    assert rel(got, want) < RTOL
    assert 0 < got[1] < 20 / 4.0 / 0.5      # the sweep stopped inside
    got = T.mean_var_conformal_set(St, 4.0, delta=0.5)
    want = J.mean_var_conformal_set(Sj, 4.0, delta=0.5)
    assert rel(got, want) < RTOL
    theta = np.asarray(J.rate)
    new_j, new_t = (Sj, jnp.asarray(points[:3]), 1.0), (St, points[:3], 1.0)
    assert T.conformal_score_func(torch.as_tensor(theta.copy()), new_t, 1) == \
        pytest.approx(J.conformal_score_func(jnp.asarray(theta), new_j, 1),
                      rel=1e-12)
    load_rate_estimator_state(T, rate=np.asarray(rate0))
    J.rate = rate0
