"""Port parity: the confidence parameters and sets of
stpy_tpu_torch/probability/likelihoods.py of every `type`
("adaptive-AB", "LR", "prior-posterior", "mutny", "laplace"), the GLM fits
of the JAX package's own cases (tests/test_inference.py) and
`add_data_point`, against stpy_tpu on the CPU, with the bars of
tests/test_torch_port_likelihoods.py: deterministic values within 1e-10
relative, the L-BFGS fits within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import probability as jpb
from stpy_tpu.opt.lbfgs import minimize_lbfgs as j_lbfgs
from stpy_tpu_torch import probability as tpb
from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs as t_lbfgs

from test_torch_port_likelihoods import (
    _MASK, _TH, _X, _Y, DET, ITER, N, pair, rel, t,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_confidence_parameters_match_jax():
    H = np.diag([0.5, 1.0, 2.0])
    ests = [None] + [_TH + 0.1 * k for k in range(6)]
    ev = [int(v) for v in _MASK]
    base = {"regularizer_hessian": H, "bound": 1.3, "sigma": 0.3,
            "evidence": ev}
    pj = dict(base, regularizer_hessian=jnp.asarray(H),
              estimator_sequence=[None if e is None else jnp.asarray(e)[:, None]
                                  for e in ests])
    pt = dict(base, regularizer_hessian=t(H),
              estimator_sequence=[None if e is None else t(e)[:, None]
                                  for e in ests])
    cases = {"gaussian": ("adaptive-AB", "LR", "prior-posterior", None),
             "poisson": ("adaptive-AB", "LR", "mutny", "laplace"),
             "bernoulli": ("LR", None)}
    thj, tht = jnp.asarray(_TH), t(_TH)
    for name, types in cases.items():
        j, m = pair(name)
        for typ in types:
            if name != "bernoulli":
                assert rel(m.confidence_parameter(0.05, pt, type=typ),
                           j.confidence_parameter(0.05, pj, type=typ)) < DET
            cs_j = j.get_confidence_set(thj, type=typ, params=pj, delta=0.05)
            cs_t = m.get_confidence_set(tht, type=typ, params=pt, delta=0.05)
            assert type(cs_t).__name__ == type(cs_j).__name__, (name, typ)
            assert rel(cs_t.beta, cs_j.beta) < DET, (name, typ)
            if typ == "LR":
                for th in (_TH, 1.5 * _TH):
                    assert rel(cs_t.objective(t(th)),
                               cs_j.objective(jnp.asarray(th))) < DET
                    assert rel(cs_t.penalty(t(th)),
                               cs_j.penalty(jnp.asarray(th))) < DET
            else:
                assert rel(cs_t.L, cs_j.L) < DET, (name, typ)
                for a, b in zip(cs_t.as_slice_params(), cs_j.as_slice_params()):
                    assert rel(a, b) < DET, (name, typ)
        cs_j = j.get_confidence_set_cvxpy(thj, params=dict(pj, estimate=thj))
        cs_t = m.get_confidence_set_cvxpy(tht, params=dict(pt, estimate=tht))
        assert rel(cs_t.L, cs_j.L) < DET


@pytest.mark.parametrize("name", ["poisson", "bernoulli"])
def test_glm_fit_matches_jax(name):
    """The JAX package's own GLM recovery cases (tests/test_inference.py),
    fitted by each package's L-BFGS from 0."""
    rng = np.random.default_rng(1 if name == "poisson" else 2)
    if name == "poisson":
        X = rng.uniform(-1, 1, (300, 2))
        th = np.array([0.8, -0.4])
        y = rng.poisson(np.exp(X @ th)).astype(float)
        j, m = jpb.PoissonLikelihoodCanonical(), \
            tpb.PoissonLikelihoodCanonical(device="cpu", dtype=torch.float64)
    else:
        X = rng.standard_normal((400, 2))
        th = np.array([1.5, -1.0])
        y = rng.binomial(1, 1 / (1 + np.exp(-X @ th))).astype(float)
        j, m = jpb.BernoulliLikelihoodCanonical(), \
            tpb.BernoulliLikelihoodCanonical(device="cpu", dtype=torch.float64)
    j.load_data((jnp.asarray(X), jnp.asarray(y)))
    m.load_data((X, y))
    rj = j_lbfgs(j.get_objective(), jnp.zeros(2), max_iter=200)
    rt = t_lbfgs(m.get_objective(), torch.zeros(2, dtype=torch.float64),
                 max_iter=200)
    assert rel(rt.x, rj.x) < ITER
    assert np.allclose(rt.x.numpy(), th, atol=0.2 if name == "poisson" else 0.4)
    if name == "poisson":
        cs = m.get_confidence_set(rt.x, type="laplace", params={})
        assert bool(cs.contains(rt.x)) and bool(cs.contains(t(th)))


def test_add_data_point_matches_load_data():
    j, m = pair("gaussian")
    m2 = tpb.GaussianLikelihood(sigma=0.3, device="cpu", dtype=torch.float64)
    for i in range(N):
        m2.add_data_point((_X[i:i + 1], _Y["real"][i:i + 1]))
    assert torch.equal(m2.x, m.x) and torch.equal(m2.y, m.y)
    assert rel(m2.get_objective()(t(_TH)), j.get_objective()(
        jnp.asarray(_TH))) < DET
