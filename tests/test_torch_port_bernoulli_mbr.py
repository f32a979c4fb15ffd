"""Port parity: `LogLinearRateEstimator`, `MBRPositiveEstimator`,
`BernoulliPointProcess`, `BernoulliRateEstimator` and
`LinkBernoulliRateEstimator` against stpy_tpu on the CPU, JAX in x64 and
the port in float64 on the same data (tests/test_torch_port_poisson.py's
1-D rounds; Bernoulli outcomes drawn by numpy from a known p).

* Log-linear: the least-squares θ (a convex fit) within 1e-6, the
  regression covariance, its pseudo-inverse and the multiplicative bounds
  on the JAX fit within 1e-8.
* MBR, `psd` on and off: the fitted objective within 1e-8 relative of the
  JAX fit's, the totals within 1e-6; the binned fit likewise; the vec(Θ)
  covariance and the regression / bins bands on the JAX fit's Θ within
  1e-8.
* Bernoulli: the penalised MAP's objective within 1e-8 and its set
  probabilities within 1e-6 (FISTA, 1000 steps); the Laplace covariance,
  `ucb` / `lcb` (the ellipsoid slice with the polytope; unconstrained for
  the logistic link) on the JAX fit within 1e-6, and `sample` (proximal
  Langevin, 12 steps, the JAX package's draws) within 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.domains import HierarchicalBorelSets as JaxHier
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.point_processes import binomial as jbin
from stpy_tpu.point_processes import LogLinearRateEstimator as JaxLogLin
from stpy_tpu.point_processes import MBRPositiveEstimator as JaxMBR
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_estimator_arrays
from stpy_tpu_torch.domains import HierarchicalBorelSets as TorchHier
from stpy_tpu_torch.point_processes import binomial as tbin
from stpy_tpu_torch.point_processes import LogLinearRateEstimator as TorchLogLin
from stpy_tpu_torch.point_processes import MBRPositiveEstimator as TorchMBR
from test_torch_port_poisson import rounds
from test_torch_port_samplers import chain_draws, feed

from torch_threads import one_torch_thread  # noqa: F401
from test_torch_port_link_estimators import (  # noqa: F401
    jax_quadrature_below_the_domain,
)

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
LEVELS, GAMMA = 3, 0.4
FIT_RTOL, OBJ_RTOL, TOTAL_RTOL, RTOL = 1e-6, 1e-8, 1e-6, 1e-8
STEPS = 12


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def hierarchies():
    return (JaxHier(1, [[-1.0, 1.0]], levels=LEVELS),
            TorchHier(1, [[-1.0, 1.0]], levels=LEVELS, **F64))


def kernels():
    return (JaxKernel(kernel_name="squared_exponential", gamma=GAMMA, d=1),
            TorchKernel(kernel_name="squared_exponential", gamma=GAMMA, d=1,
                        **F64))


def poisson_pair(jcls, tcls, m, **kw):
    jh, th = hierarchies()
    jk, tk = kernels()
    common = dict(d=1, m=m, B=4.0, s=0.1, jitter=1e-5, b=0.0,
                  basis="triangle", **kw)
    J = jcls(None, jh, kernel_object=jk, **common)
    T = tcls(None, th, kernel_object=tk, **common, **F64)
    jd, td = rounds(jh, th)
    J.load_data(jd)
    T.load_data(td)
    return J, T, jh, th


# -- log-linear ----------------------------------------------------------------------

def test_loglinear_fit_covariance_and_bounds_match_jax():
    J, T, jh, th = poisson_pair(JaxLogLin, TorchLogLin, 8)
    J.fit_gp()
    T.fit_gp()
    assert rel(T.rate, J.rate) <= FIT_RTOL
    load_estimator_arrays(T, rate=np.asarray(J.rate))
    assert rel(T.construct_covariance_matrix_regression(),
               J.construct_covariance_matrix_regression()) < RTOL
    for S_t, S_j in zip(th.get_sets_level(2), jh.get_sets_level(2)):
        got = T.mean_var_reg_set(S_t, dt=0.5, beta=2.0)
        want = J.mean_var_reg_set(S_j, dt=0.5, beta=2.0)
        for g, w in zip(got, want):
            assert rel(g, w) < RTOL
    assert abs(T.ucb(S_t) - J.ucb(S_j)) <= RTOL * abs(J.ucb(S_j))
    assert abs(T.lcb(S_t) - J.lcb(S_j)) <= RTOL * abs(J.ucb(S_j))
    assert rel(T.W_inv, J.W_inv) < RTOL
    x = th.top_node.return_discretization(5)
    assert rel(T.mean_rate_points(x),
               J.mean_rate_points(jnp.asarray(x.numpy()))) < RTOL


# -- MBR ----------------------------------------------------------------------------

@pytest.mark.parametrize("psd", [False, True])
def test_mbr_fit_matches_jax(psd):
    J, T, jh, th = poisson_pair(JaxMBR, TorchMBR, 6, psd=psd)
    J.fit_gp()
    T.fit_gp()
    sumLambda, obs = T.sumLambda, T.observations
    mult = T.obs_multiplicities

    def objective(Theta):
        Theta = torch.as_tensor(np.asarray(Theta))
        q = torch.einsum("ij,jk,ik->i", obs, Theta, obs)
        return float(-torch.sum(mult * torch.log(torch.clamp(q, min=1e-12)))
                     + torch.trace(sumLambda @ Theta)
                     + T.s * torch.sum(Theta ** 2))

    fj, ft = objective(J.rate), objective(T.rate.detach())
    assert (ft - fj) / abs(fj) <= OBJ_RTOL
    assert rel(T.mean_set(th.top_node), J.mean_set(jh.top_node)) <= TOTAL_RTOL
    if psd:
        assert float(torch.linalg.eigvalsh(T.rate).min()) >= -1e-12


def test_mbr_bins_fit_and_bands_match_jax():
    J, T, jh, th = poisson_pair(JaxMBR, TorchMBR, 6, estimator="least-sq")
    assert rel(T.varLambdas_vec, J.varLambdas_vec) < 1e-12
    J.penalized_likelihood_bins()
    T.penalized_likelihood_bins()
    assert rel(T.mean_set(th.top_node), J.mean_set(jh.top_node)) <= TOTAL_RTOL
    load_estimator_arrays(T, rate=np.asarray(J.rate))
    assert rel(T.construct_covariance_matrix(),
               J.construct_covariance_matrix()) < RTOL
    for E in (J, T):
        E.approx_fit = False
    for S_t, S_j in zip(th.get_sets_level(3), jh.get_sets_level(3)):
        _, ut, lt = T.mean_var_bins_set(S_t, dt=2.0, lcb_compute=True)
        _, uj, lj = J.mean_var_bins_set(S_j, dt=2.0, lcb_compute=True)
        assert abs(float(ut) - float(uj)) <= RTOL * abs(float(uj))
        assert abs(float(lt) - float(lj)) <= RTOL * abs(float(uj))
        assert abs(T.ucb(S_t) - J.ucb(S_j)) <= RTOL * abs(J.ucb(S_j))
        assert abs(T.lcb(S_t) - J.lcb(S_j)) <= RTOL * abs(J.ucb(S_j))
    x = th.top_node.return_discretization(5)
    assert rel(T.mean_rate_points(x),
               J.mean_rate_points(jnp.asarray(x.numpy()))) < RTOL
    assert rel(T.rate_value(x, dt=2.0),
               J.rate_value(jnp.asarray(x.numpy()), dt=2.0)) < RTOL


# -- Bernoulli ------------------------------------------------------------------------

def true_p(S):
    return 0.2 + 0.5 * float(S.center_point()[0] > 0)


def bernoulli_pair(link, draws=12):
    jh, th = hierarchies()
    jk, tk = kernels()
    jcls = jbin.LinkBernoulliRateEstimator if link else jbin.BernoulliRateEstimator
    tcls = tbin.LinkBernoulliRateEstimator if link else tbin.BernoulliRateEstimator
    J = jcls(jh, d=1, m=8, kernel_object=jk, s=0.05)
    T = tcls(th, d=1, m=8, kernel_object=tk, s=0.05, **F64)
    rng = np.random.default_rng(0)
    jd, td = [], []
    for S_j, S_t in zip(jh.get_sets_level(LEVELS), th.get_sets_level(LEVELS)):
        for _ in range(draws):
            rv = float(rng.uniform() < true_p(S_j))
            jd.append((S_j, rv, 1.0, 1.0, None))
            td.append((S_t, rv, 1.0, 1.0, None))
    J.load_data(jd)
    T.load_data(td)
    return J, T, jh, th


@pytest.mark.parametrize("link", [False, True], ids=["polytope", "logistic"])
def test_bernoulli_estimator_matches_jax(link, monkeypatch):
    J, T, jh, th = bernoulli_pair(link)
    assert rel(T.varphis, J.varphis) < 1e-12 and rel(T.phis, J.phis) < 1e-12
    J.fit_gp()
    T.fit_gp()

    def objective(E, theta):
        th_ = torch.as_tensor(np.asarray(theta))
        return float(T._nll(th_) + T._polytope_penalty(th_))

    fj, ft = objective(J, J.rate), objective(T, T.rate)
    assert (ft - fj) / abs(fj) <= OBJ_RTOL
    leaves_t, leaves_j = th.get_sets_level(LEVELS), jh.get_sets_level(LEVELS)
    for S_t, S_j in zip(leaves_t, leaves_j):
        assert abs(T.mean_set(S_t) - J.mean_set(S_j)) <= TOTAL_RTOL
    load_estimator_arrays(T, rate=np.asarray(J.rate))
    assert rel(T.construct_covariance(T.rate),
               J.construct_covariance(J.rate)) < RTOL
    shifted = np.asarray(J.rate) + 0.1
    assert rel(T.nabla(torch.as_tensor(shifted)),
               J.nabla(jnp.asarray(shifted))) < RTOL
    # the bounds need not bracket mean_set: with the polytope the JAX
    # package's lcb lies above the MAP's p on the left leaves here and its
    # ucb below it on the right ones, and the port's with it (ROADMAP
    # Queue 3)
    S_t, S_j = leaves_t[0], leaves_j[0]
    assert abs(T.ucb(S_t) - J.ucb(S_j)) <= FIT_RTOL
    assert abs(T.lcb(S_t) - J.lcb(S_j)) <= FIT_RTOL
    J.key = jax.random.PRNGKey(9)
    _, sub = jax.random.split(J.key)
    it = feed(monkeypatch, chain_draws(sub, STEPS, (8,)))
    J.sample(steps=STEPS)
    T.sample(steps=STEPS)
    assert next(it, None) is None
    assert rel(T.sampled_theta, J.sampled_theta) < RTOL


def test_bernoulli_process_draws_at_its_rate():
    th = TorchHier(1, [[-1.0, 1.0]], levels=2, **F64)
    S = th.get_sets_level(2)[1]
    proc = tbin.BernoulliPointProcess(th.get_sets_level(2), d=1,
                                      rate=lambda _S: 0.3)
    assert proc.is_basic(S)
    g = torch.Generator().manual_seed(0)
    outs = [proc.sample(g, S, t=1, dt=1.0) for _ in range(2000)]
    assert all(o[0] is S and o[2] == 1.0 for o in outs)
    p_hat = np.mean([o[1] for o in outs])
    assert abs(p_hat - 0.3) < 4 * np.sqrt(0.3 * 0.7 / 2000)


def test_bernoulli_estimator_resolves_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    th = TorchHier(1, [[-1.0, 1.0]], levels=2, **F64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbin.BernoulliRateEstimator(th, d=1, m=4)
