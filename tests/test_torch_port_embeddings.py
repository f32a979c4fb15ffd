"""Port parity: the embeddings of stpy_tpu_torch/embeddings (trig,
combinators, polynomial, random maps, NMF) and `linalg.symsqrt` /
`woodbury_inv_update` against stpy_tpu on the CPU.

The same numpy inputs go through both packages, JAX in x64 and torch in
float64. Frequencies and weights are built in numpy in both, so from the
same seed W must be identical (bitwise). Closed-form feature values,
integrals and derivatives agree within 1e-12 relative to their largest
entry. Where a JAX PRNG picks the state (RandomMap's weights, the NMF
start) it is carried across (`convert.load_embedding_state`) or fed to
both. Adam's iterates (RandomMap.fit_map) agree within 1e-10: optax and
torch.optim round the same update in another order.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import embeddings as J
from stpy_tpu_torch import embeddings as T

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-12
BOX = SimpleNamespace(bounds=np.array([[-0.5, 0.7], [-0.9, 0.3]]))


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def points(n=20, d=2, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d))


# (class name, kwargs): every trig embedding, each sampler and density
TRIG = [
    ("RFFEmbedding", dict(gamma=0.4, m=40, d=2, approx="rff")),
    ("RFFEmbedding", dict(gamma=0.4, m=40, d=2, approx="rff",
                          kernel="laplace", seed=3)),
    ("RFFEmbedding", dict(gamma=0.4, m=40, d=2, approx="halton")),
    ("RFFEmbedding", dict(gamma=0.4, m=40, d=2, approx="halton",
                          kernel="laplace")),
    ("RFFEmbedding", dict(gamma=0.4, m=40, d=2, approx="orf", seed=5)),
    ("QuadratureEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("QuadratureEmbedding", dict(gamma=0.5, m=64, d=2, kernel="laplace")),
    ("QuadratureEmbedding", dict(gamma=0.5, m=32, d=1,
                                 kernel="modified_matern", nu=3)),
    ("TrapezoidalEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("ClenshawCurtisEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("HermiteEmbedding", dict(gamma=0.5, m=32, d=1)),
    ("HermiteEmbedding", dict(gamma=0.5, m=128, d=2, ones=True)),
    ("OverCompleteHermiteEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("MaternEmbedding", dict(gamma=0.5, m=64, d=2, kernel="modified_matern",
                             nu=2)),
    ("MaternEmbedding", dict(gamma=0.5, m=32, d=1, kernel="laplace")),
    ("QuadPeriodicEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("KLEmbedding", dict(gamma=0.5, m=64, d=2)),
    ("LatticeEmbedding", dict(gamma=0.5, m=64, d=2)),
]


@pytest.mark.parametrize("name,kw", TRIG,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRIG)])
def test_trig_embedding_matches_jax(name, kw):
    je = getattr(J, name)(**kw)
    te = getattr(T, name)(**kw, **F64)
    assert te.get_m() == je.get_m()
    assert np.array_equal(te.W.numpy(), np.asarray(je.W))
    assert np.array_equal(te.weights.numpy(), np.asarray(je.weights))
    d = kw["d"]
    x = points(d=d)
    S = SimpleNamespace(bounds=BOX.bounds[:d])
    for method, args in (("embed", (x,)), ("derivative_1", (x,)),
                         ("derivative_2", (x,)), ("integral", (S,)),
                         ("product_integral", (S,))):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args]
        got = getattr(te, method)(*args).numpy()
        assert rel(got, getattr(je, method)(*jargs)) <= RTOL, method


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_box_integrals_keep_the_zero_frequency_limit(dtype):
    """A zero frequency coordinate integrates to b − a exactly, in both
    dtypes; the others match the closed form in float64."""
    W = np.array([[0.0, 0.0], [0.0, 2.0], [1.5, -0.5]])
    c, s = T.box_trig_integrals(torch.tensor(W, dtype=dtype), BOX.bounds)
    (a0, b0), (a1, b1) = BOX.bounds
    assert c.dtype == dtype
    assert float(c[0]) == np.float32((b0 - a0) * (b1 - a1)) or \
        dtype == torch.float64
    want = []
    for w in W:
        terms = [b - a if abs(wj) < 1e-12 else
                 (np.exp(1j * wj * b) - np.exp(1j * wj * a)) / (1j * wj)
                 for wj, (a, b) in zip(w, BOX.bounds)]
        want.append(np.prod(terms))
    want = np.array(want)
    tol = 1e-15 if dtype == torch.float64 else 1e-6
    assert rel(c.double().numpy(), want.real) <= tol
    assert np.max(np.abs(s.double().numpy() - want.imag)) <= tol
    jc, js = J.box_trig_integrals(jnp.asarray(W), BOX.bounds)
    if dtype == torch.float64:
        assert rel(c.numpy(), jc) <= RTOL
        assert np.max(np.abs(s.numpy() - np.asarray(js))) <= RTOL
