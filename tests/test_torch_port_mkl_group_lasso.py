"""Port parity: stpy_tpu_torch/models/mkl.py's group-lasso `MKL` against
stpy_tpu/models/mkl.py on the CPU.

The same numpy data (seeded) and the same Hermite embeddings go through
both packages, JAX in x64 and torch in float64, on the JAX package's own
case (tests/test_mkl_and_misc.py). The fit (FISTA with the group soft
threshold, 1000 iterations at most) agrees within 1e-6 relative, and
meets the JAX package's own bars.
"""

import numpy as np

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import HermiteEmbedding as JHermite
from stpy_tpu.models import mkl as jm
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.models import mkl as tm

from test_torch_port_mkl import ITER, TK64, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def embeddings(Emb, kw, gammas, m):
    return [Emb(gamma=g, m=m, d=1, **kw) for g in gammas]


def test_feature_mkl_matches_jax():
    """The JAX package's own group-lasso case (tests/test_mkl_and_misc.py)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (80, 1))
    y = np.sin(3 * x)
    j = jm.MKL(embeddings(JHermite, {}, (0.4, 5.0), 32), lam=2.0, s=0.1)
    t = tm.MKL(embeddings(THermite, TK64, (0.4, 5.0), 32), lam=2.0, s=0.1)
    j.fit_gp(x, y)
    t.fit_gp(x, y)
    assert rel(t.theta, j.theta) < ITER and rel(t.weights, j.weights) < ITER
    w = t.weights.numpy()
    assert w[0] > 5 * w[1]
    mu, _ = t.mean_var(x)
    assert rel(mu, jax.jit(j.mean_var)(jnp.asarray(x))[0]) < ITER
    assert np.abs(mu.numpy() - y).mean() < 0.1
    assert t.get_embed_dims() == j.get_embed_dims() == [32, 32]
    assert t.total_embed_dim() == 64
    assert rel(t.sample(x, size=3), j.sample(jnp.asarray(x), size=3)) < ITER
