"""Port parity: stpy_tpu_torch/probability/likelihoods.py against
stpy_tpu/probability/likelihoods.py on the CPU.

The same numpy data (seeded) are loaded into each likelihood of both
packages, JAX in x64 and torch in float64. Every likelihood's objective
(with and without an evidence mask), `evaluate_datapoint`, information
matrix (at no fit, at a fit, masked), `scale` and default confidence set
(its square-root information matrix, centre and β) agree within 1e-10
relative. The confidence parameters of every `type`, the GLM fits and
`add_data_point` are in tests/test_torch_port_likelihoods_confidence.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import probability as jpb
from stpy_tpu_torch import probability as tpb

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
ITER = 1e-6
N, D = 30, 3

_rng = np.random.default_rng(21)
_X = _rng.uniform(-1, 1, (N, D))
_TH = np.array([0.6, -0.4, 0.3])
_Y = {
    "real": _X @ _TH + 0.1 * _rng.standard_normal(N),
    "count": _rng.poisson(np.exp(_X @ _TH)).astype(float),
    "binary": _rng.binomial(1, 1 / (1 + np.exp(-_X @ _TH))).astype(float),
    "positive": np.exp(_X @ _TH) * _rng.weibull(1.5, N),
}
_MASK = _rng.uniform(size=N) < 0.6
_S = (lambda a: a @ a.T / N + 0.5 * np.eye(N))(_rng.standard_normal((N, N)))

CASES = {
    "gaussian": (lambda m, kw: m.GaussianLikelihood(sigma=0.3, **kw), "real"),
    "gaussian_Sigma": (lambda m, kw: m.GaussianLikelihood(
        sigma=0.3, Sigma=_S, **kw), "real"),
    "poisson": (lambda m, kw: m.PoissonLikelihoodCanonical(**kw), "count"),
    "bernoulli": (lambda m, kw: m.BernoulliLikelihoodCanonical(**kw), "binary"),
    "laplace": (lambda m, kw: m.LaplaceLikelihood(b=0.2, **kw), "real"),
    "huber": (lambda m, kw: m.HuberLikelihood(sigma=0.1, delta=1.0, **kw),
              "real"),
    "weibull": (lambda m, kw: m.WeibullLikelihoodCanonical(kk=1.5, **kw),
                "positive"),
    "robust": (lambda m, kw: m.RobustGraphicalLikelihood(
        coin=0.1, supp=2.0, sigma=0.2, **kw), "real"),
}


def rel(got, want):
    """Max relative difference; a NaN must sit where the reference has
    one (√β of a negative β)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def pair(name):
    make, kind = CASES[name]
    j = make(jpb, {})
    m = make(tpb, {"device": "cpu", "dtype": torch.float64})
    j.load_data((jnp.asarray(_X), jnp.asarray(_Y[kind])))
    m.load_data((_X, _Y[kind]))
    return j, m


@pytest.mark.parametrize("name", list(CASES))
def test_likelihood_matches_jax(name):
    j, m = pair(name)
    for th in (_TH, np.array([0.1, 0.2, -0.5])):
        thj, tht = jnp.asarray(th)[:, None], t(th)[:, None]
        assert rel(m.get_objective()(tht), j.get_objective()(thj)) < DET
        assert rel(m.get_objective(mask=_MASK)(tht),
                   j.get_objective(mask=jnp.asarray(_MASK))(thj)) < DET
        assert rel(m.get_objective_cvxpy()(tht[:, 0]),
                   j.get_objective_cvxpy()(thj[:, 0])) < DET
        d_j, d_t = (j.x[3:5], j.y[3:5]), (m.x[3:5], m.y[3:5])
        if name != "gaussian_Sigma":
            assert rel(m.evaluate_datapoint(tht, d_t, mask=0.5),
                       j.evaluate_datapoint(thj, d_j, mask=0.5)) < DET
        assert rel(m.information_matrix(tht), j.information_matrix(thj)) < DET
        cs_j = j.get_confidence_set(thj[:, 0], params={})
        cs_t = m.get_confidence_set(tht[:, 0], params={})
        assert rel(cs_t.L, cs_j.L) < DET and rel(cs_t.center, cs_j.center) < DET
        assert rel(cs_t.beta, cs_j.beta) < DET
        assert bool(cs_t.contains(tht[:, 0])) == bool(cs_j.contains(thj[:, 0]))
    assert rel(m.information_matrix(), j.information_matrix()) < DET
    if name in ("gaussian", "laplace", "huber", "robust"):
        assert rel(m.information_matrix(mask=_MASK),
                   j.information_matrix(mask=jnp.asarray(_MASK))) < DET
    bound = 0.7
    assert rel(m.scale(bound=bound), j.scale(bound=bound)) < DET
    assert m.normalization(None) == pytest.approx(j.normalization(None),
                                                  rel=DET)
    if name.startswith("gaussian"):
        f = _rng.standard_normal((N, 1))
        assert rel(m.evaluate_log(t(f)), j.evaluate_log(jnp.asarray(f))) < DET


def test_likelihoods_default_to_the_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpb.GaussianLikelihood(sigma=0.1)
    lik = tpb.PoissonLikelihoodCanonical(device="cpu")
    lik.load_data((_X, _Y["count"]))
    assert lik.x.device.type == "cpu" and lik.x.dtype == torch.float32
    assert torch.isfinite(lik.get_objective()(torch.zeros(D))).item()
