"""Port parity: `PoissonRateEstimator` (stpy_tpu_torch/point_processes) and
its data model against stpy_tpu on the CPU: the construction, the data
bookkeeping, and every MAP route of `fit_gp`.

The same sensing rounds (numpy points) go to both packages, JAX in x64 and
torch in float64, on the 1-D hierarchy of tests/test_pp_reference_parity.py
(16 triangle functions, 3 levels, s = 0.1; every leaf twice and two
level-2 sets, one round with duplicate points). The basis integrals
`varphis`, the variances, Γ^{1/2}, the bucketization, the embedded
observations and their multiplicities, and the running log-likelihood agree
to 1e-10 relative; Γ^{-1/2} to 1e-10 times Γ^{1/2}'s condition number.

The MAP fits run L-BFGS on objectives whose curvature reaches about 1e12,
and their iterates part in the last digits. They are compared by what they
minimise: where the optimum is interior, against the closed form of the
weighted least squares (as test_pp_reference_parity.py:214-240 does), to
1e-6; otherwise the port's fit may lie at most 1e-6 relative above the JAX
fit's value of the same objective, and the fitted totals (`mean_set` on
the whole domain) agree to 5e-3. The JAX package pads its arrays to powers
of two (`jit_pad`); the port accepts the keyword and pads nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.domains import HierarchicalBorelSets as JaxHier
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.point_processes import PoissonRateEstimator as JaxPRE
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.domains import HierarchicalBorelSets as TorchHier
from stpy_tpu_torch.point_processes import PoissonRateEstimator as TorchPRE

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
M, LEVELS, GAMMA, B, S_REG, JITTER = 16, 3, 0.4, 4.0, 0.1, 1e-5
RTOL, OBJ_RTOL, TOTAL_RTOL = 1e-10, 1e-6, 5e-3
MAX_ITER = 3000       # the default: every route converges within it here


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def rounds(jh, th, seed=0):
    """Every leaf twice and two level-2 sets; dt grows; rates ~2 (interior
    of the box (0, B)); the third round repeats one of its points."""
    rng = np.random.default_rng(seed)
    jl, tl = jh.get_sets_level(LEVELS), th.get_sets_level(LEVELS)
    sets = list(zip(jl, tl)) * 2 + list(zip(jh.get_sets_level(LEVELS - 1),
                                            th.get_sets_level(LEVELS - 1)))[:2]
    jd, td = [], []
    for i, (js, ts) in enumerate(sets):
        lo, hi = np.asarray(js.bounds)[0]
        dt = float(4.0 + 0.5 * i)
        k = max(1, int(rng.poisson(2.0 * (hi - lo) * dt)))
        pts = rng.uniform(lo + 1e-3, hi - 1e-3, (k, 1))
        if i == 2:
            pts = np.vstack([pts, pts[:1]])
        jd.append((js, jnp.asarray(pts), dt))
        td.append((ts, pts, dt))
    return jd, td


def make_pair(feedback="count-record", estimator="likelihood", d=1,
              jit_pad=False, data=True, **kw):
    jh = JaxHier(d, [[-1.0, 1.0]] * d, levels=LEVELS)
    th = TorchHier(d, [[-1.0, 1.0]] * d, levels=LEVELS, **F64)
    common = dict(d=d, m=M, B=B, s=S_REG, jitter=JITTER, b=0.0,
                  basis="triangle", feedback=feedback, estimator=estimator,
                  map_max_iter=MAX_ITER, **kw)
    J = JaxPRE(None, jh, kernel_object=JaxKernel(
        kernel_name="squared_exponential", gamma=GAMMA, d=d),
        jit_pad=jit_pad, **common)
    T = TorchPRE(None, th, kernel_object=TorchKernel(
        kernel_name="squared_exponential", gamma=GAMMA, d=d, **F64),
        jit_pad=jit_pad, **common, **F64)
    if data:
        jd, td = rounds(jh, th)
        J.load_data(jd)
        T.load_data(td)
    return J, T, jh, th


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_construction_matches_jax(pair):
    J, T, jh, th = pair
    assert [t_.bounds.numpy().tolist() for t_ in T.basic_sets] == \
        [np.asarray(s.bounds).tolist() for s in J.basic_sets]
    assert rel(T.varphis, J.varphis) < RTOL
    assert rel(T.variances, J.variances) < RTOL
    Gj, Gij = J.cov(inverse=True)
    Gt, Git = T.cov(inverse=True)
    assert rel(Gt, Gj) < RTOL
    # the pseudo-inverse carries Γ^{1/2}'s rounding times its condition
    # number (1.2e5 here; the two LAPACK chains part by 6.6e-13 in Γ^{1/2})
    assert rel(Git, Gij) < RTOL * np.linalg.cond(Gt.numpy())
    for a, b in zip(T.get_constraints(), J.get_constraints()):
        assert rel(a, b) < RTOL
    assert T.get_min_max() == J.get_min_max() and T.get_m() == M
    assert rel(T.W, J.W) < RTOL


def test_data_model_and_bucketization_match_jax(pair):
    J, T, *_ = pair
    assert T.n_rounds == J.n_rounds == len(T.data)
    assert rel(T.phis, J.phis) < RTOL
    assert rel(T.counts, J.counts) < RTOL
    assert rel(T.observations, J.observations) < RTOL
    assert rel(T.obs_multiplicities, J.obs_multiplicities) < RTOL
    assert float(T.obs_multiplicities.max()) == 2.0       # the duplicate
    assert rel(T.x, J.x) < RTOL
    assert np.array_equal(T.bucketized_counts.numpy(),
                          np.asarray(J.bucketized_counts))
    assert rel(T.total_bucketized_obs, J.total_bucketized_obs) < RTOL
    assert rel(T.total_bucketized_time, J.total_bucketized_time) < RTOL
    for a, b in zip(T.bucketized_obs, J.bucketized_obs):
        assert np.array_equal(a, b)
    assert T.bucketized_time == J.bucketized_time
    assert rel(T.get_observations(), J.get_observations()) < RTOL
    for v in (0.37, 1.0, 5.0, 42.0):
        assert T.variance_correction(v) == J.variance_correction(v)


def test_jit_pad_is_accepted_and_pads_nothing():
    J, T, *_ = make_pair(jit_pad=True)
    n = T.n_rounds
    assert J.phis.shape[0] > n == T.phis.shape[0] == J.n_rounds
    assert rel(T.phis, J.phis[:n]) < RTOL
    assert T.observations.shape[0] < J.observations.shape[0]


def test_add_data_point_and_the_running_likelihood_match_jax():
    J, T, jh, th = make_pair(data=False)
    jd, td = rounds(jh, th, seed=3)
    for k, (a, b) in enumerate(zip(jd[:6] + jd[-2:], td[:6] + td[-2:])):
        if k == 4:
            a, b = (a[0], None, a[2]), (b[0], None, b[2])
        J.add_data_point(a)
        T.add_data_point(b)
    assert T.loglikelihood == pytest.approx(J.loglikelihood, rel=RTOL)
    n = T.n_rounds
    assert rel(T.phis, J.phis[:n]) < RTOL and rel(T.counts, J.counts[:n]) < RTOL
    assert np.array_equal(T.bucketized_counts.numpy(),
                          np.asarray(J.bucketized_counts))
    assert rel(T.total_bucketized_obs, J.total_bucketized_obs) < RTOL
    assert rel(T.total_bucketized_time, J.total_bucketized_time) < RTOL
    k = T.observations.shape[0]
    assert rel(T.observations, J.observations[:k]) < RTOL


# -- the MAP fits -----------------------------------------------------------

def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def objective(T, route):
    """The objective (in θ, float64) that `route` minimises, from the
    port's data model; θ = Γ^{-1/2}w, so the penalty s/2‖Γ^{-1/2}w‖² is
    s/2‖θ‖²."""
    s = T.s
    if route == "count-record/likelihood":
        O, mult, P = T.observations, T.obs_multiplicities, T.phis
        return lambda th: (-torch.sum(mult * torch.log(torch.clamp(O @ th, min=1e-12)))
                           + torch.sum(P @ th) + 0.5 * s * th @ th)
    P, c = T.phis, T.counts
    if route in ("histogram/likelihood", "histogram/bins"):
        return lambda th: (-torch.sum(c * torch.log(torch.clamp(P @ th, min=1e-12)))
                           + torch.sum(P @ th) + 0.5 * s * th @ th)
    if route == "histogram/least-sq":
        var = _t([S.volume() * T.B * T.variance_correction(S.volume() * T.B)
                  for S, _, _ in T.data])
        return lambda th: (torch.sum(((P @ th - c) / torch.sqrt(var)) ** 2)
                           + s * th @ th)
    tau, obs = T.total_bucketized_time, T.total_bucketized_obs
    V = T.varphis
    if route == "count-record/bins":
        mask = T.bucketized_counts > 0
        return lambda th: (-torch.sum(torch.where(
            mask, obs * torch.log(torch.clamp(tau * (V @ th), min=1e-12)), 0.0))
            + torch.sum(tau * (V @ th)) + 0.5 * s * th @ th)
    if route == "count-record/least-sq":
        var = _t(T._bucket_variances())
        return lambda th: (torch.sum(((tau * (V @ th) - obs) / torch.sqrt(var)) ** 2)
                           + 0.5 * s * th @ th)
    if route == "dual":
        A, wts = T.anchor_points_emb, T.anchor_weights
        return lambda th: (-torch.sum(torch.where(
            wts > 0, wts * torch.log(torch.clamp(A @ th, min=1e-12)), 0.0))
            + torch.sum(tau * (V @ th)) + 0.5 * s * th @ th)
    raise KeyError(route)


def assert_fit_matches(J, T, route, top):
    J.fit_gp()
    T.fit_gp()
    f = objective(T, route)
    fj, ft = float(f(_t(J.rate))), float(f(T.rate))
    assert ft <= fj + OBJ_RTOL * abs(fj), (route, ft, fj)
    # the box holds: l + 1e-4 ≤ Γ^{1/2}θ ≤ u
    w = T.cov() @ T.rate
    assert float(w.min()) >= 1e-4 - 1e-9 and float(w.max()) <= B + 1e-9
    tj = float(J.mean_set(J.hierarchy.top_node)[0])
    tt = float(T.mean_set(top)[0])
    assert abs(tt - tj) <= TOTAL_RTOL * abs(tj), (route, tt, tj)
    return fj, ft


ROUTES = [("count-record", "likelihood"), ("count-record", "least-sq"),
          ("count-record", "bins"), ("histogram", "likelihood"),
          ("histogram", "least-sq"), ("histogram", "bins")]


@pytest.mark.parametrize("feedback,estimator", ROUTES,
                         ids=[f"{a}-{b}" for a, b in ROUTES])
def test_map_fit_routes_match_jax_by_objective(feedback, estimator):
    J, T, jh, th = make_pair(feedback, estimator)
    assert_fit_matches(J, T, f"{feedback}/{estimator}", th.top_node)
    # a warm refit starts from the fitted rate and stays at the optimum
    f = objective(T, f"{feedback}/{estimator}")
    before = float(f(T.rate))
    T.fit_gp()
    assert float(f(T.rate)) <= before + OBJ_RTOL * abs(before)


def test_dual_anchor_fit_matches_jax():
    # 64 anchors: at 16 and 32 one of the two solves stalls with a
    # coordinate saturated at u, where its zoom L-BFGS (no step clip)
    # sees no gradient (ROADMAP Queue 3)
    J, T, jh, th = make_pair(dual=True, no_anchor_points=64)
    assert rel(T.anchor_points, J.anchor_points) < RTOL
    assert rel(T.anchor_weights, J.anchor_weights) < RTOL
    assert rel(T.anchor_points_emb, J.anchor_points_emb) < RTOL
    assert_fit_matches(J, T, "dual", th.top_node)


def test_fit_without_observations_matches_jax():
    J, T, jh, th = make_pair(data=False)
    assert T.fit_gp() is None and T.rate is None
    S = th.get_sets_level(LEVELS)
    T.load_data([(S[0], None, 2.0), (S[3], None, 1.0)])
    J.load_data([(jh.get_sets_level(LEVELS)[0], None, 2.0),
                 (jh.get_sets_level(LEVELS)[3], None, 1.0)])
    J.fit_gp()
    T.fit_gp()
    P, s = T.phis, T.s
    f = lambda th_: torch.sum(P @ th_) + 0.5 * s * th_ @ th_   # noqa: E731
    fj, ft = float(f(_t(J.rate))), float(f(T.rate))
    assert ft <= fj + OBJ_RTOL * abs(fj)


def test_wls_fit_lands_on_the_interior_closed_form(pair):
    """The least-squares optimum is interior here, so the box fit equals
    the normal equations' solution of its objective."""
    _, T, *_ = make_pair(estimator="least-sq")
    mask = (T.bucketized_counts > 0).numpy()
    tau = T.total_bucketized_time.numpy()
    obs = T.total_bucketized_obs.numpy()
    var = T._bucket_variances()
    Phi = tau[mask, None] * T.varphis.numpy()[mask]
    D = 1.0 / var[mask]
    A = 2.0 * (Phi * D[:, None]).T @ Phi + S_REG * np.eye(M)
    theta_star = np.linalg.solve(A, 2.0 * (Phi * D[:, None]).T @ obs[mask])
    w_star = T.cov().numpy() @ theta_star
    assert w_star.min() > 0.05 and w_star.max() < B - 0.05, w_star
    rate = T.least_squares_weighted().numpy()
    assert np.abs(rate - theta_star).max() < 1e-6 * max(
        1.0, np.abs(theta_star).max())


def test_unknown_routes_raise():
    _, T, *_ = make_pair(data=False)
    T.data, T.estimator = [], "nope"
    with pytest.raises(AssertionError, match="wrong name"):
        T.fit_gp()
    th = TorchHier(1, [[-1.0, 1.0]], levels=2, **F64)
    with pytest.raises(NotImplementedError, match="positive basis"):
        TorchPRE(None, th, basis="nope", m=4, **F64)
