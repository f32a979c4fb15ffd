"""Port parity: the link-function rate estimators
(stpy_tpu_torch/point_processes/link_estimators.py) against stpy_tpu on the
CPU: `PermanentalProcessRateEstimator` (λ = (Φθ)²),
`LogisticGaussProcessRateEstimator` (softplus),
`ExpGaussProcessRateEstimator` (exp(−Φθ)) and
`LogGaussProcessRateEstimator` (B·sigmoid).

The sensing rounds of tests/test_torch_port_poisson.py (1-D, levels 3,
8 triangle functions, every leaf twice and two level-2 sets) go to both
packages, JAX in x64 and the port in float64. The random starts of the fits
and the ULA chains are the JAX package's own draws (regenerated with
`jax.random.split` / `normal` from the estimator's key and fed to the
port's `link_estimators._normal` and `langevin._normal`).

* Construction and data: Ψ(S), ΣΨ·dt and the quadrature nodes/weights
  within 1e-12.
* `fit_gp`: the fitted objective within 1e-8 relative of the JAX fit's,
  and the fitted totals (`mean_set` of the domain, sign-invariant for the
  quadratic link) within 1e-6; the L-BFGS iterates of these flat, partly
  non-convex objectives part in the last digits.
* On the JAX fit's θ (carried by `convert.load_estimator_arrays`): the
  Laplace covariances, `mean_set`, `mean_rate_points`, `ucb` / `lcb` and
  `map_lcb_ucb_approx_action` within 1e-8; `sample` (ULA, 30 steps) and
  the sampled paths within 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.domains import HierarchicalBorelSets as JaxHier
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.point_processes import link_estimators as jle
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_estimator_arrays
from stpy_tpu_torch.domains import HierarchicalBorelSets as TorchHier
from stpy_tpu_torch.point_processes import link_estimators as tle
from test_torch_port_poisson import rounds
from test_torch_port_samplers import chain_draws, feed

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
M, LEVELS, GAMMA, B, S_REG = 8, 3, 0.4, 4.0, 0.1
DATA_RTOL, OBJ_RTOL, TOTAL_RTOL, RTOL = 1e-12, 1e-8, 1e-6, 1e-8
STEPS = 30
CLASSES = ["PermanentalProcessRateEstimator",
           "LogisticGaussProcessRateEstimator",
           "ExpGaussProcessRateEstimator", "LogGaussProcessRateEstimator"]


@pytest.fixture(autouse=True, scope="module")
def jax_quadrature_below_the_domain():
    """The triangle basis's closed-form `product_integral` integrates over
    its whole domain box whatever S is; the JAX estimators use it for every
    set, the port only for that box (ROADMAP Queue 3). The JAX package's
    own quadrature route takes the other sets here: its closed form raises
    for them for this module's run, so its estimators fall back to their
    Gauss-Legendre rule as the port does."""
    from stpy_tpu.embeddings import positive as jpos

    orig = jpos.TriangleEmbedding.product_integral

    def guarded(self, S):
        b = np.asarray(S.bounds)
        lo, hi = self.interval
        if not (np.all(b[:, 0] == lo) and np.all(b[:, 1] == hi)):
            raise NotImplementedError("a set smaller than the domain")
        return orig(self, S)

    jpos.TriangleEmbedding.product_integral = guarded
    yield orig
    jpos.TriangleEmbedding.product_integral = orig


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def make_pair(name, **kw):
    jh = JaxHier(1, [[-1.0, 1.0]], levels=LEVELS)
    th = TorchHier(1, [[-1.0, 1.0]], levels=LEVELS, **F64)
    common = dict(d=1, m=M, B=B, s=S_REG, jitter=1e-5, b=0.0,
                  basis="triangle", **kw)
    J = getattr(jle, name)(None, jh, kernel_object=JaxKernel(
        kernel_name="squared_exponential", gamma=GAMMA, d=1), **common)
    T = getattr(tle, name)(None, th, kernel_object=TorchKernel(
        kernel_name="squared_exponential", gamma=GAMMA, d=1, **F64),
        **common, **F64)
    jd, td = rounds(jh, th)
    J.load_data(jd)
    T.load_data(td)
    return J, T, jh, th


def feed_starts(monkeypatch, J, shape):
    """The JAX fit's start: normal(split(key)[1], shape), fed to the port."""
    _, sub = jax.random.split(J.key)
    draws = [np.asarray(jax.random.normal(sub, shape, jnp.float64))]

    def take(_generator, shp, dtype, device):
        out = draws.pop(0)
        assert tuple(shp) == out.shape
        return torch.as_tensor(out, dtype=dtype, device=device)

    monkeypatch.setattr(tle, "_normal", take)


@pytest.fixture(scope="module", params=CLASSES[:2])
def pair(request):
    """The quadratic and softplus links; the exp and sigmoid links run the
    same tests in tests/test_torch_port_link_estimators_exp_log.py."""
    return make_pair(request.param)


def test_construction_and_data_match_jax(pair):
    J, T, jh, th = pair
    assert rel(T.sumLambda, J.sumLambda) < DATA_RTOL
    S_t, S_j = th.get_sets_level(2)[1], jh.get_sets_level(2)[1]
    assert rel(T.product_integral(S_t), J.product_integral(S_j)) < DATA_RTOL
    assert rel(T.varLambdas, J.varLambdas) < DATA_RTOL
    for lo, hi in zip(T.get_constraints(), J.get_constraints()):
        assert rel(lo, hi) < DATA_RTOL
    if hasattr(J, "nodes"):
        assert rel(T.nodes, J.nodes) < DATA_RTOL
        assert rel(T.weights, J.weights) < DATA_RTOL


def test_leaf_product_integrals_are_the_leaves(pair,
                                               jax_quadrature_below_the_domain):
    """The port's Ψ of the leaves sums to Ψ of their union, to the
    Gauss-Legendre rule's error across the hats' kinks (4.5e-4 here); the
    JAX package's closed form gives each leaf its whole domain's Ψ."""
    J, T, jh, th = pair
    leaves_t = th.get_sets_level(LEVELS)
    total = sum(T.product_integral(S) for S in leaves_t)
    assert rel(total, T.product_integral(th.top_node)) < 1e-3
    closed = jax_quadrature_below_the_domain
    leaf_j = jh.get_sets_level(LEVELS)[0]
    assert rel(closed(J.packing, leaf_j), closed(J.packing, jh.top_node)) \
        < 1e-15
    assert rel(T.product_integral(leaves_t[0]),
               closed(J.packing, leaf_j)) > 0.5


def _objective(T, theta):
    """The fit's objective, evaluated by the port at θ."""
    f = T._link_loss() if isinstance(T, tle._LinkMAP) else T._quadratic_nll(0.5)
    return float(f(torch.as_tensor(np.asarray(theta))))


def test_fit_matches_jax(pair, monkeypatch):
    J, T, jh, th = pair
    name = type(T).__name__
    if name != "ExpGaussProcessRateEstimator":
        shape = (8, M) if name == "PermanentalProcessRateEstimator" else (M,)
        feed_starts(monkeypatch, J, shape)
    J.fit_gp()
    T.fit_gp()
    # the objective, evaluated by the port at both fits
    fj = _objective(T, np.asarray(J.rate))
    ft = _objective(T, T.rate.detach().numpy())
    assert (ft - fj) / abs(fj) <= OBJ_RTOL
    top_t, top_j = th.top_node, jh.top_node
    assert rel(T.mean_set(top_t), J.mean_set(top_j)) <= TOTAL_RTOL
    x = top_t.return_discretization(9)
    assert rel(T.mean_rate_points(x),
               J.mean_rate_points(jnp.asarray(x.numpy()))) <= 1e-4


@pytest.fixture(scope="module")
def fitted(pair):
    J, T, jh, th = pair
    if J.rate is None:
        J.fit_gp()
    load_estimator_arrays(T, rate=np.asarray(J.rate))
    return J, T, jh, th


def test_covariance_and_set_values_on_the_jax_fit(fitted):
    J, T, jh, th = fitted
    assert rel(T.construct_covariance_matrix_laplace(),
               J.construct_covariance_matrix_laplace()) < RTOL
    for S_t, S_j in zip(th.get_sets_level(2), jh.get_sets_level(2)):
        assert rel(T.mean_set(S_t, dt=2.0), J.mean_set(S_j, dt=2.0)) < RTOL
    x = th.top_node.return_discretization(7)
    assert rel(T.mean_rate_points(x),
               J.mean_rate_points(jnp.asarray(x.numpy()))) < RTOL
    assert rel(T.mean_rate(th.top_node, n=5), J.mean_rate(jh.top_node, n=5)) \
        < RTOL


def test_bounds_on_the_jax_fit(fitted):
    J, T, jh, th = fitted
    for E in (J, T):
        E.approx_fit = False
    S_t, S_j = th.get_sets_level(3)[2], jh.get_sets_level(3)[2]
    ucb_t, ucb_j = T.ucb(S_t, dt=2.0), J.ucb(S_j, dt=2.0)
    lcb_t, lcb_j = T.lcb(S_t, dt=2.0), J.lcb(S_j, dt=2.0)
    assert abs(ucb_t - ucb_j) <= RTOL * abs(ucb_j)
    assert abs(lcb_t - lcb_j) <= RTOL * max(abs(ucb_j), abs(lcb_j))
    assert lcb_t <= float(T.mean_set(S_t, dt=2.0)) <= ucb_t
    W = J.construct_covariance_matrix_laplace()
    load_estimator_arrays(T, W_inv_approx=np.linalg.pinv(np.asarray(W)))
    J.W_inv_approx = jnp.linalg.pinv(W)
    got = T.map_lcb_ucb_approx_action(S_t, dt=2.0)
    want = J.map_lcb_ucb_approx_action(S_j, dt=2.0)
    assert rel(got[0], want[0]) < RTOL and rel(got[2], want[2]) < RTOL


def test_sample_matches_jax_on_the_same_draws(fitted, monkeypatch):
    J, T, jh, th = fitted
    J.key = jax.random.PRNGKey(5)
    _, sub = jax.random.split(J.key)
    it = feed(monkeypatch, chain_draws(sub, STEPS, (M,)))
    J.sample(steps=STEPS)
    T.sample(steps=STEPS)
    assert next(it, None) is None
    assert rel(T.sampled_theta, J.sampled_theta) < RTOL
    x = th.top_node.return_discretization(5)
    assert rel(T.sample_path_points(x),
               J.sample_path_points(jnp.asarray(x.numpy()))) < RTOL
    S_t, S_j = th.get_sets_level(2)[0], jh.get_sets_level(2)[0]
    assert rel(T.sample_value(S_t), J.sample_value(S_j)) < RTOL


def test_estimators_resolve_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    th = TorchHier(1, [[-1.0, 1.0]], levels=2, **F64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tle.LogGaussProcessRateEstimator(None, th, d=1, m=4)
