"""Port parity: stpy_tpu_torch/models/mkl.py's `PrimalMKL` against
stpy_tpu/models/mkl.py on the CPU.

The same numpy data (seeded) and the same Hermite embeddings go through
both packages, JAX in x64 and torch in float64, on the JAX package's own
case (tests/test_mkl_and_misc.py). The fit (alternating L-BFGS and
simplex steps, 3 alternations) agrees within 1e-6 relative, and meets the
JAX package's own bars.
"""

import numpy as np
import pytest

from stpy_tpu.embeddings import HermiteEmbedding as JHermite
from stpy_tpu.models import mkl as jm
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.models import mkl as tm

from test_torch_port_mkl import ITER, TK64, rel
from test_torch_port_mkl_group_lasso import embeddings
from torch_threads import one_torch_thread  # noqa: F401


def test_primal_mkl_matches_jax():
    """The JAX package's own primal case (tests/test_mkl_and_misc.py)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (40, 1))
    y = np.sin(3 * x)
    j = jm.PrimalMKL(embeddings(JHermite, {}, (0.4, 1.0), 16), lam=0.01,
                     s=0.1)
    t = tm.PrimalMKL(embeddings(THermite, TK64, (0.4, 1.0), 16), lam=0.01,
                     s=0.1)
    j.fit_gp(x, y, outer_steps=3)
    t.fit_gp(x, y, outer_steps=3)
    assert rel(t.weights, j.weights) < ITER and rel(t.theta, j.theta) < ITER
    assert float(t.weights.sum()) == pytest.approx(1.0, abs=1e-5)
    mu, _ = t.mean_var(x)
    assert np.abs(mu.numpy() - y).mean() < 0.3
