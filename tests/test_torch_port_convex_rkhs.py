"""Port parity: stpy_tpu_torch/models/convex_rkhs.py against
stpy_tpu/models/convex_rkhs.py on the CPU, on the JAX package's own case
(tests/test_aux_components.py).

The same numpy data and Hermite embedding go through both packages, JAX
in x64 and torch in float64. A local ridge fit agrees within 1e-10
relative; the metric fit (two L-BFGS restarts of 30 iterations from the
JAX package's own starting draws, fed to the port's `_normal`: the JAX
package vmaps them, the port runs one solve each) and the posterior mean
on it within 1e-6.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import HermiteEmbedding as JHermite
from stpy_tpu.models import ConvexRKHS as JConvex
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.models import ConvexRKHS as TConvex
from stpy_tpu_torch.models import convex_rkhs as tcr

from test_torch_port_gp_models_tail import DET, F64, ITER, TK64, feed, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def convex_pair():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (25, 1))
    j = JConvex(JHermite(gamma=0.8, m=16, d=1), m=16, lam=1e-3, s=0.1)
    t = TConvex(THermite(gamma=0.8, m=16, d=1, **TK64), m=16, lam=1e-3,
                s=0.1)
    j.fit_gp(x, x**2)
    t.fit_gp(x, x**2)
    return j, t, x


def test_convex_rkhs_matches_jax(monkeypatch):
    """The JAX package's own case; its restarts start from the squares of
    its normal draws, fed to the port's `_normal`. The JAX calls run under
    `jax.jit` (its `optimize_params` traced whole: the metric it returns is
    the eager call's bit for bit, and is set back on the model, which the
    trace left holding a tracer)."""
    j, t, x = convex_pair()
    w = np.exp(-np.linspace(0, 2, 25))
    assert rel(t.local_fit(torch.tensor(w)),
               jax.jit(j.local_fit)(jnp.asarray(w))) < DET
    g0 = jax.random.normal(jax.random.PRNGKey(1), (2, 16), F64)
    feed(monkeypatch, tcr, "_normal", [torch.tensor(np.asarray(g0))])
    gj = jax.jit(lambda: j.optimize_params(restarts=2, maxiter=30))()
    j.gamma_metric = gj
    gt = t.optimize_params(restarts=2, maxiter=30)
    assert rel(gt, gj) < ITER
    mu_t, _ = t.mean_std(x)
    assert rel(mu_t, jax.jit(j.mean_std)(jnp.asarray(x))[0]) < ITER
    assert np.abs(mu_t.numpy() - x**2).mean() < 0.15
    assert rel(t.mean(x), mu_t) == 0.0


def test_convex_rkhs_lives_on_its_embedding_device():
    _, t, x = convex_pair()
    assert t.gamma_metric.device.type == "cpu"
    assert t.gamma_metric.dtype == torch.float64
    assert t.mean(x).shape == (25, 1)
