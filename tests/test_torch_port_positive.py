"""Port parity: the positive bases of stpy_tpu_torch/embeddings/positive.py,
embeddings/bernstein.py and Nyström's positive subclasses against
stpy_tpu on the CPU.

The same kernel, grids and sets go through both packages, JAX in x64 and
torch in float64. Γ^{1/2} and its pseudo-inverse (`cov`), the embeddings,
the closed-form and quadrature box integrals and the product integrals
agree to 1e-10 relative: the chain pinv → symsqrt on the grid Gram is
float64 LAPACK on both sides. The constrained `fit` (1000 steps of box
FISTA on the same objective) agrees to 1e-8. `PositiveNystromEmbeddingBump`
draws its basis from GP prior samples, which cannot be reproduced across
the packages: the JAX basis and Γ^{1/2} are carried over by
`convert.load_positive_embedding_state` and the rest held on them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import domains as jd
from stpy_tpu.embeddings import bernstein as jb
from stpy_tpu.embeddings import nystrom as jn
from stpy_tpu.embeddings import positive as jp
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch import domains as td
from stpy_tpu_torch.convert import load_positive_embedding_state
from stpy_tpu_torch.embeddings import bernstein as tb
from stpy_tpu_torch.embeddings import nystrom as tn
from stpy_tpu_torch.embeddings import positive as tp

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def kernels(d, gamma=0.4):
    return (JaxKernel(kernel_name="squared_exponential", gamma=gamma, d=d),
            TorchKernel(kernel_name="squared_exponential", gamma=gamma, d=d,
                        **F64))


def pair(jcls, tcls, d, m, kernel=True, **kw):
    jk, tk = kernels(d) if kernel else (None, None)
    return (jcls(d, m, kernel_object=jk, **kw),
            tcls(d, m, kernel_object=tk, **kw, **F64))


def set_pair(d, levels=2):
    J = jd.HierarchicalBorelSets(d, [[-1.0, 1.0]] * d, levels)
    T = td.HierarchicalBorelSets(d, [[-1.0, 1.0]] * d, levels, **F64)
    return J.get_all_sets(), T.get_all_sets()


def points(d, n=40, seed=0):
    return np.random.default_rng(seed).uniform(-1.05, 1.05, (n, d))


BASES = [
    ("triangle-1d", jp.TriangleEmbedding, tp.TriangleEmbedding, 1, 9, {}),
    ("triangle-2d", jp.TriangleEmbedding, tp.TriangleEmbedding, 2, 5, {}),
    ("faber", jp.FaberSchauderEmbedding, tp.FaberSchauderEmbedding, 1, 8, {}),
    ("bernstein-1d", jb.BernsteinEmbedding, tb.BernsteinEmbedding, 1, 6, {}),
    ("bernstein-2d", jb.BernsteinEmbedding, tb.BernsteinEmbedding, 2, 4, {}),
    ("splines", jb.BernsteinSplinesEmbedding, tb.BernsteinSplinesEmbedding,
     1, 8, {}),
    ("overlap-splines", jb.BernsteinSplinesOverlapping,
     tb.BernsteinSplinesOverlapping, 1, 8, {}),
    ("bumps", jp.BumpsEmbedding, tp.BumpsEmbedding, 1, 7, {}),
    ("kuhn", jp.KuhnExponentialEmbedding, tp.KuhnExponentialEmbedding, 1, 5,
     dict(gamma=0.3, interval=(0, 1))),
]


@pytest.mark.parametrize("name,jcls,tcls,d,m,kw", BASES,
                         ids=[b[0] for b in BASES])
def test_basis_cov_embed_and_integrals_match_jax(name, jcls, tcls, d, m, kw):
    J, T = pair(jcls, tcls, d, m, B=4.0, b=0.0, s=np.sqrt(1e-5), offset=0.1,
                **kw)
    assert T.get_m() == J.get_m()
    Gj, Gij = J.cov(inverse=True)
    Gt, Git = T.cov(inverse=True)
    assert rel(Gt, Gj) < RTOL and rel(Git, Gij) < RTOL
    x = points(d)
    assert rel(T.embed_internal(x), J.embed_internal(jnp.asarray(x))) < RTOL
    assert rel(T.embed(x), J.embed(jnp.asarray(x))) < RTOL
    for a, b in zip(T.get_constraints(), J.get_constraints()):
        assert rel(a, b) < RTOL
    js, ts = set_pair(d, levels=2 if d == 2 else 3)
    if name in ("faber", "splines", "overlap-splines") or d == 1:
        js, ts = js[:7], ts[:7]
    Ij = np.stack([np.asarray(J.integral(S)) for S in js])
    It = torch.stack([T.integral(S) for S in ts])
    assert rel(It, Ij) < RTOL
    assert T.integral(ts[0]) is T.integral(ts[0]) or name in (
        "faber", "splines", "overlap-splines")
    if hasattr(J, "product_integral") and (d == 1 or name.startswith("tri")):
        assert rel(T.product_integral(ts[0]), J.product_integral(js[0])) < RTOL


def test_triangle_ball_integral_and_closed_forms_match_jax():
    J, T = pair(jp.TriangleEmbedding, tp.TriangleEmbedding, 2, 5, B=4.0,
                s=1e-3)
    Jball, Tball = jd.BallSet(2, [0.1, -0.2], 0.6), td.BallSet(
        2, [0.1, -0.2], 0.6, **F64)
    assert rel(T.integral(Tball), J.integral(Jball)) < RTOL
    a, b = torch.tensor(-0.3, dtype=torch.float64), torch.tensor(
        0.45, dtype=torch.float64)
    assert rel(T.integral_1d_all(a, b),
               J.integral_1d_all(jnp.asarray(-0.3), jnp.asarray(0.45))) < RTOL
    assert rel(T.basis_fun(points(1), 2), J.basis_fun(jnp.asarray(points(1)),
                                                      2)) < RTOL


def test_faber_mask_and_the_identity_cov_match_jax():
    J, T = pair(jp.FaberSchauderEmbedding, tp.FaberSchauderEmbedding, 1, 8,
                kernel=False)
    assert rel(T.hierarchical_mask(), J.hierarchical_mask()) < RTOL
    assert rel(T.cov(), J.cov()) < RTOL
    with pytest.raises(AssertionError, match="log_2"):
        tp.FaberSchauderEmbedding(1, 6, **F64)


def test_custom_haar_bumps_match_jax():
    kw = dict(nodes=[-0.5, 0.0, 0.5], widths=[0.3, 0.2, 0.4],
              weights=[1.0, 2.0, 0.5], B=3.0)
    J = jp.CustomHaarBumps(1, 3, **kw)
    T = tp.CustomHaarBumps(1, 3, **kw, **F64)
    x = points(1)
    assert rel(T.embed(x), J.embed(jnp.asarray(x))) < RTOL
    js, ts = set_pair(1, levels=2)
    assert rel(T.integral(ts[1]), J.integral(js[1])) < RTOL


def test_constrained_fit_matches_jax():
    J, T = pair(jp.TriangleEmbedding, tp.TriangleEmbedding, 1, 8, B=2.0,
                b=0.0, s=0.1)
    x = np.linspace(-1, 1, 25)[:, None]
    y = 1.0 + np.sin(3 * x[:, 0])
    xj = J.fit(jnp.asarray(x), jnp.asarray(y))
    xt = T.fit(x, y)
    assert rel(xt, xj) < 1e-8
    assert rel(T.mean(x), J.mean(jnp.asarray(x))) < 1e-8


def test_positive_nystrom_basis_on_the_jax_basis_matches_jax():
    jk, tk = kernels(1, gamma=0.3)
    J = jn.PositiveNystromEmbeddingBump(1, 4, kernel_object=jk, samples=40,
                                        B=4.0, s=1e-3)
    T = tn.PositiveNystromEmbeddingBump(1, 4, kernel_object=tk, samples=40,
                                        B=4.0, s=1e-3, **F64)
    # the port's own basis: nonnegative, one column per function
    grid = np.asarray(J.borel_set.return_discretization(256))
    own = T.embed_internal(grid)
    assert own.shape == (256, 4) and bool((own >= 0).all())
    Gj, Gij = J.cov(inverse=True)
    load_positive_embedding_state(T, Gj, Gij, grid=grid[:, 0],
                                  basis=J.GP.embed(jnp.asarray(grid)))
    x = points(1)
    assert rel(T.embed(x), J.embed(jnp.asarray(x))) < RTOL
    js, ts = set_pair(1, levels=3)
    assert rel(torch.stack([T.integral(S) for S in ts]),
               np.stack([np.asarray(J.integral(S)) for S in js])) < RTOL
    for a, b in zip(T.get_constraints(), J.get_constraints()):
        assert rel(a, b) < RTOL


def test_f32_basis_takes_its_chain_from_the_double_float_grid_gram():
    """The port's departure: an f32 kernel's grid Gram enters the float64
    pinv/symsqrt chain as the double-float Gram, not rounded to f32. At
    32² nodes and SE γ = 0.1 the f32 Gram's rounding, clipped at the
    chain's eigenvalue floor, raises Γ^{1/2}'s condition number from 7.4e3
    to 3.5e6; through the double-float Gram the f32 basis is float64's
    rounded."""
    from stpy_tpu_torch.embeddings.positive import pinv64
    from stpy_tpu_torch.linalg import symsqrt

    emb = {}
    for dtype in (torch.float32, torch.float64):
        k = TorchKernel(kernel_name="squared_exponential", gamma=0.1, d=2,
                        device="cpu", dtype=dtype)
        emb[dtype] = tp.TriangleEmbedding(2, 32, kernel_object=k, B=4.0,
                                          offset=0.1, s=np.sqrt(1e-7),
                                          device="cpu", dtype=dtype)
    G64 = emb[torch.float64].cov()
    e32 = emb[torch.float32]
    assert rel(e32.cov(), G64) < 1e-5
    cond64 = float(torch.linalg.cond(G64))
    assert float(torch.linalg.cond(e32.cov().double())) == pytest.approx(
        cond64, rel=1e-2)
    # the chain on the f32 Gram, as the JAX package feeds it outside x64
    t = e32._grid_nodes()
    Gam = e32.kernel_object.gram(t).double()
    Z = e32.embed_internal(t).double()
    eye = torch.eye(Gam.shape[0], dtype=torch.float64)
    Gh = symsqrt(pinv64(Z.T @ Z + e32.s * eye)) @ symsqrt(
        Gam + 1e-5 * e32.s**2 * eye)
    assert float(torch.linalg.cond(Gh)) > 100 * cond64
