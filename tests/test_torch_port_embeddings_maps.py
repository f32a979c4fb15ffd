"""Port parity: the embedding combinators, the polynomial and packing
embeddings, the random NN maps from carried weights, NMF from a fed
start, and `linalg.symsqrt` / `woodbury_inv_update` of stpy_tpu_torch
against stpy_tpu on the CPU, with the bars of
tests/test_torch_port_embeddings.py (which holds the trigonometric
embeddings and the box integrals).
"""

from types import SimpleNamespace

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import embeddings as J
from stpy_tpu import linalg as JL
from stpy_tpu.embeddings.nystrom import nmf_multiplicative as jax_nmf
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu_torch import embeddings as T
from stpy_tpu_torch import linalg as TL
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.convert import load_embedding_state

from test_torch_port_embeddings import BOX, F64, RTOL, points, rel
from test_torch_port_gp_methods import feed
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_combinators_match_jax():
    x = points(n=15, d=2, seed=1)
    kw = dict(gamma=0.5, m=32, d=1)
    ja, jb = J.HermiteEmbedding(**kw), J.RFFEmbedding(**kw, seed=2)
    ta, tb = T.HermiteEmbedding(**kw, **F64), T.RFFEmbedding(**kw, seed=2,
                                                            **F64)
    w = np.linspace(0.5, 1.5, ja.get_m())
    S = SimpleNamespace(bounds=BOX.bounds[:1])
    pairs = [
        (J.ConcatEmbedding([ja, jb]), T.ConcatEmbedding([ta, tb]),
         x[:, :1], True),
        (J.MaskedEmbedding(ja, lambda z: z[:, 0] > 0),
         T.MaskedEmbedding(ta, lambda z: z[:, 0] > 0), x[:, :1], False),
        (J.AdditiveEmbeddings([ja, jb], groups=[[1], [0]],
                              scaling=[0.5, 2.0]),
         T.AdditiveEmbeddings([ta, tb], groups=[[1], [0]],
                              scaling=[0.5, 2.0]), x, False),
        (J.ProjectiveEmbeddings(ja, lambda z: z[:, :1] + z[:, 1:]),
         T.ProjectiveEmbeddings(ta, lambda z: z[:, :1] + z[:, 1:]), x,
         False),
        (J.WeightedEmbedding(ja, w), T.WeightedEmbedding(ta, w), x[:, :1],
         True),
    ]
    for jc, tc, xx, integral in pairs:
        assert tc.get_m() == jc.get_m()
        assert rel(tc.embed(xx).numpy(), jc.embed(jnp.asarray(xx))) <= RTOL
        if integral:
            assert rel(tc.integral(S).numpy(), jc.integral(S)) <= RTOL


def test_polynomial_embeddings_match_jax():
    x = points(n=12, d=2, seed=3)
    x[0, 1] = 0.0   # the power rule's guard at zero
    for jp, tp in (
            (J.PolynomialEmbedding(2, 3, kappa=2.0),
             T.PolynomialEmbedding(2, 3, kappa=2.0, **F64)),
            (J.PolynomialEmbedding(2, 2, include_bias=False),
             T.PolynomialEmbedding(2, 2, include_bias=False, **F64))):
        assert tp.get_m() == jp.get_m()
        assert rel(tp.embed(x).numpy(), jp.embed(jnp.asarray(x))) <= RTOL
        assert rel(tp.derivative_1(x).numpy(),
                   jp.derivative_1(jnp.asarray(x))) <= RTOL
    jc, tc = J.ChebyschevEmbedding(2, 4, kappa=0.5), T.ChebyschevEmbedding(
        2, 4, kappa=0.5, **F64)
    assert rel(tc.embed(x).numpy(), jc.embed(jnp.asarray(x))) <= RTOL
    xo = np.array([[0, 2], [1, 1], [2, 0]])
    jo, to = J.OnehotEmbedding(2, 3), T.OnehotEmbedding(2, 3, **F64)
    assert rel(to.embed(xo).numpy(), jo.embed(jnp.asarray(xo))) == 0
    # CustomEmbedding's integral by a box's Gauss-Legendre rule
    nodes, weights = np.polynomial.legendre.leggauss(6)
    S = SimpleNamespace(return_legendre_discretization=lambda q: (
        0.5 * weights, 0.5 * nodes[:, None]))
    ju = J.CustomEmbedding(1, lambda z: jnp.concatenate([z, z**2], 1), 2)
    tu = T.CustomEmbedding(1, lambda z: torch.cat([z, z**2], 1), 2, **F64)
    assert rel(tu.embed(x[:, :1]).numpy(), ju.embed(jnp.asarray(x[:, :1]))) \
        <= RTOL
    assert rel(tu.integral(S).numpy(), ju.integral(S)) <= RTOL


def test_packing_embedding_matches_jax_up_to_eigenvector_signs():
    kw = dict(kernel_name="squared_exponential", gamma=0.5, d=1)
    jp = J.PackingEmbedding(1, 6, JaxKernel(**kw), grid=32)
    tp = T.PackingEmbedding(1, 6, TorchKernel(**kw, **F64), grid=32)
    x = points(n=10, d=1, seed=4)
    je, te = np.asarray(jp.embed(jnp.asarray(x))), tp.embed(x).numpy()
    sign = np.sign(np.sum(je * te, axis=0))
    assert rel(te * sign, je) <= 1e-9
    assert rel(tp.derivative_1(x).numpy() * sign[None, :, None],
               jp.derivative_1(jnp.asarray(x))) <= 1e-9


def test_random_maps_from_carried_weights_match_jax():
    x = points(n=30, d=2, seed=6)
    y = np.sin(3 * x[:, :1]) + x[:, 1:] ** 2
    jm = J.RandomMap(2, 16, output=1, seed=0)
    tm = T.RandomMap(2, 16, output=1, seed=0, **F64)
    load_embedding_state(tm, W1=np.asarray(jm.W1), W2=np.asarray(jm.W2))
    assert rel(tm.embed(x).numpy(), jm.embed(jnp.asarray(x))) <= RTOL
    assert rel(tm.fit_map(x, y, epochs=150, lr=0.05).numpy(),
               jm.fit_map(jnp.asarray(x), jnp.asarray(y), epochs=150,
                          lr=0.05)) <= 1e-10
    jl = J.RandomMap(2, 16, output=1, seed=0)
    load_embedding_state(tm, W2=np.asarray(jl.W2))
    assert rel(tm.fit_map_lasso(x, y, epochs=100, lr=0.05, l1=0.01).numpy(),
               jl.fit_map_lasso(jnp.asarray(x), jnp.asarray(y), epochs=100,
                                lr=0.05, l1=0.01)) <= 1e-10
    assert rel(tm.fit_last_layer(x, y).numpy(),
               jm.fit_last_layer(jnp.asarray(x), jnp.asarray(y))) <= RTOL
    assert abs(float(tm.loss(x, y)) - float(jm.loss(jnp.asarray(x),
                                                    jnp.asarray(y)))) <= 1e-12
    jo, to = J.RandomOrthogonalMap(2, 8, seed=4), T.RandomOrthogonalMap(
        2, 8, seed=4, **F64)
    assert np.array_equal(to.W1.numpy(), np.asarray(jo.W1))
    jn, tn = J.RandomNestedMap(2, 8, seed=1), T.RandomNestedMap(2, 8, seed=1,
                                                                **F64)
    load_embedding_state(tn, W1=np.asarray(jn.W1), W_mid=np.asarray(jn.W_mid))
    assert rel(tn.hidden(x).numpy(), jn.hidden(jnp.asarray(x))) <= RTOL


def test_nmf_from_the_same_start_matches_jax(monkeypatch):
    rng = np.random.default_rng(7)
    X = rng.uniform(0, 1, (20, 12)) ** 2
    feed(monkeypatch, "uniform", "rand",
         [rng.uniform(0, 1, (20, 4)), rng.uniform(0, 1, (4, 12))])
    jW, jH = jax_nmf(jnp.asarray(X), 4, iters=300)
    tW, tH = T.nmf_multiplicative(torch.tensor(X), 4, iters=300)
    assert rel(tW.numpy(), jW) <= 1e-10 and rel(tH.numpy(), jH) <= 1e-10
    assert rel((tW @ tH).numpy(), np.asarray(jW @ jH)) <= 1e-12


def test_symsqrt_and_woodbury_match_jax():
    rng = np.random.default_rng(8)
    G = rng.standard_normal((10, 10))
    A = G @ G.T + 0.1 * np.eye(10)
    u = rng.standard_normal(10)
    for inv in (False, True):
        assert rel(TL.symsqrt(torch.tensor(A), inv=inv).numpy(),
                   JL.symsqrt(jnp.asarray(A), inv=inv)) <= 1e-11
    R = TL.symsqrt(torch.tensor(A, dtype=torch.float32))
    assert R.dtype == torch.float32
    assert rel((R.double() @ R.double()).numpy(), A) <= 1e-6
    Ainv = np.linalg.inv(A)
    assert rel(TL.woodbury_inv_update(torch.tensor(Ainv),
                                      torch.tensor(u)).numpy(),
               JL.woodbury_inv_update(jnp.asarray(Ainv), jnp.asarray(u))) \
        <= RTOL
    assert rel(TL.woodbury_inv_update(torch.tensor(Ainv),
                                      torch.tensor(u)).numpy(),
               np.linalg.inv(A + np.outer(u, u))) <= 1e-10
