"""Port parity: stpy_tpu_torch/regularization (the regularizers' values,
proxes, Hessians, level sets and surrogates; the simplex priors; every
constraint's penalty, check and projection; the SDP constraint's spectral
penalty and projection) against stpy_tpu/regularization on the CPU, JAX
in x64 and torch in float64, within 1e-10 relative (the bar of
tests/test_torch_port_simplex_reg.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import regularization as jr
from stpy_tpu_torch import regularization as tr

from test_torch_port_simplex_reg import (
    _GROUPS, _NESTED, _THETA, DET, _rng, rel, t,
)
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def regularizers(m):
    return {
        "l2": m.L2Regularizer(lam=2.0),
        "l1": m.L1Regularizer(lam=0.7),
        "group": m.GroupL1L2Regularizer(lam=1.3, groups=_GROUPS,
                                        weights=[1.0, 0.5, 2.0]),
        "nested": m.NestedGroupL1L2Regularizer(lam=0.9, groups=_NESTED),
        "lq": m.NonConvexLqRegularizer(lam=1.1, q=0.5),
        "group_lq": m.GroupNonConvexLqRegularizer(lam=0.8, q=0.7,
                                                  groups=_GROUPS),
    }


def test_regularizers_match_jax():
    J, T = regularizers(jr), regularizers(tr)
    thj, tht = jnp.asarray(_THETA), t(_THETA)
    eta = np.abs(_rng.standard_normal(6)) + 0.1
    for name in J:
        j, m = J[name], T[name]
        assert m.is_convex() == j.is_convex(), name
        assert rel(m.eval(tht), j.eval(thj)) < DET, name
        assert rel(m.prox(tht, 0.3), j.prox(thj, 0.3)) < DET, name
        hj, ht = j.hessian(thj), m.hessian(tht)
        assert (hj is None) == (ht is None), name
        if hj is not None:
            assert rel(ht, hj) < DET, name
        level_j, level_t = j.get_constraint_level_set(0.5), \
            m.get_constraint_level_set(0.5)
        assert rel(level_t(tht), level_j(thj)) < DET, name
        assert rel(m.get_regularizer_cvxpy()(tht),
                   j.get_regularizer_cvxpy()(thj)) < DET, name
    for name, e in (("lq", eta), ("group_lq", eta[:3])):
        assert rel(T[name].surrogate(t(e))(tht),
                   J[name].surrogate(jnp.asarray(e))(thj)) < DET, name
    # the JAX package's own values (tests/test_mkl_and_misc.py)
    th = t([1.0, -2.0, 0.5])
    assert float(tr.L2Regularizer(lam=2.0).eval(th)) == pytest.approx(5.25)
    assert np.allclose(tr.L1Regularizer(lam=1.0).prox(th, 0.5).numpy(),
                       [0.5, -1.5, 0.0])


def test_simplex_regularizers_match_jax():
    th = np.array([0.2, 0.5, 0.3])
    w = np.array([0.5, 1.5, 2.0])
    for cls in ("ProbabilityRegularizer", "SupRegularizer",
                "DirichletRegularizer", "WeightedAitchisonRegularizer",
                "L1MeasureRegularizer"):
        for kw in ({"lam": 0.4, "d": 3}, {"lam": 1.7, "w": w, "d": 3}):
            kj = dict(kw, w=jnp.asarray(w)) if "w" in kw else kw
            j, m = getattr(jr, cls)(**kj), getattr(tr, cls)(**kw)
            assert rel(m.eval(t(th)), j.eval(jnp.asarray(th))) < DET, cls
            assert m.name == j.name and m.convex == j.convex, cls


def constraints(m, dev):
    kw = {} if dev is None else {"device": dev, "dtype": torch.float64}
    A = np.eye(4)
    Q = (lambda a: a @ a.T)(np.random.default_rng(5).standard_normal((4, 4)))
    return {
        "custom": m.CustomConstraint(lambda th: th[0] ** 2 + th[1] - 0.5,
                                     project_fn=lambda th: 0.5 * th),
        "linear": m.LinearConstraint(A, l=-0.3 * np.ones(4),
                                     u=0.4 * np.ones(4), **kw),
        "abs": m.AbsoluteValueConstraint(c=0.8),
        "quadratic": m.QuadraticInequalityConstraint(
            Q, b=np.array([0.1, -0.2, 0.3, 0.0]), c=0.5, **kw),
        "nonconvex": m.NonConvexNormConstraint(q=0.5, c=0.6, d=4),
        "nonconvex_group": m.NonConvexGroupNormConstraint(
            q=0.5, c=0.6, d=4, groups=[[0, 1], [2, 3]]),
    }


def test_constraints_match_jax():
    J, T = constraints(jr, None), constraints(tr, "cpu")
    th = np.array([0.7, -0.5, 0.2, 0.9])
    for name in J:
        j, m = J[name], T[name]
        for scale in (1.0, 0.05):
            thj, tht = jnp.asarray(scale * th), t(scale * th)
            assert rel(m.penalty(tht), j.penalty(thj)) < DET, name
            assert bool(m.satisfied(tht)) == bool(j.satisfied(thj)), name
            if name in ("quadratic", "nonconvex_group"):
                continue
            assert rel(m.project(tht), j.project(thj)) < DET, name
    # the JAX package's own case (tests/test_mkl_and_misc.py)
    c = tr.AbsoluteValueConstraint(c=1.0)
    proj = c.project(t([0.8, -0.6]))
    assert float(torch.sum(torch.abs(proj))) <= 1.0 + 1e-6
    assert bool(c.satisfied(proj, tol=1e-5))


@pytest.mark.parametrize("kind", ["psd", "trace", "stable_rank"])
def test_sdp_constraint_matches_jax(kind):
    a = np.random.default_rng(7).standard_normal((5, 5))
    A = a + a.T
    kw = {"psd": {"type": "trace"},
          "trace": {"trace_constraint": 2.0, "lambda_max_constraint": 1.5},
          "stable_rank": {"type": "stable-rank", "rank": 2.0,
                          "trace_constraint": 3.0}}[kind]
    j, m = jr.SDPConstraint(**kw), tr.SDPConstraint(**kw)
    for l in (1.0, 4.0):
        assert rel(m.penalty(t(A), l=l), j.penalty(jnp.asarray(A), l=l)) < DET
    assert rel(m.project(t(A)), j.project(jnp.asarray(A))) < DET
