"""Port parity: stpy_tpu_torch/models/{gamma_process,trace_features}.py
against stpy_tpu/models on the CPU, JAX in x64 and torch in float64, with
the bars of tests/test_torch_port_gp_models_tail.py: `GammaContProcess`
(an exact GP) within 1e-10; `TraceFeatures`' fits (L-BFGS, plain and PSD,
over their first 50 iterations) within 1e-6, its posterior on those fits
with them. Each case is the JAX package's own
(tests/test_aux_components.py, tests/test_misc_components.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stpy_tpu.embeddings import HermiteEmbedding as JHermite
from stpy_tpu.models import TraceFeatures as JTrace
from stpy_tpu.models import trace_features as jtf
from stpy_tpu.models.gamma_process import GammaContProcess as JGamma
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.models import GammaContProcess as TGamma
from stpy_tpu_torch.models import TraceFeatures as TTrace
from stpy_tpu_torch.models import trace_features as ttf

from test_torch_port_gp_models_tail import DET, ITER, TK64, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_gamma_process_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (20, 1))
    xt = np.linspace(-1, 1, 8)[:, None]
    j, t = JGamma(gamma=0.5, s=0.1, d=1), TGamma(gamma=0.5, s=0.1, d=1, **TK64)
    j.fit_gp(x, np.sin(x))
    t.fit_gp(x, np.sin(x))
    for a, b in zip(t.mean_var(xt), j.mean_var(jnp.asarray(xt))):
        assert rel(a, b) < DET
    mu, S = t.mean_var(xt, full=True)
    assert rel(S, j.mean_var(jnp.asarray(xt), full=True)[1]) < DET
    for kw in ({"kernel_name": "squared_exponential"},
               {"kernel_name": "matern", "nu": 1.5},
               {"kernel_name": "linear"},
               {"kernel_name": "squared_exponential", "groups": [[0], [1]]}):
        jg, tg = JGamma(d=2, **kw), TGamma(d=2, **kw, **TK64)
        for t_ in (10, 100):
            assert tg.get_gamma(t_) == pytest.approx(jg.get_gamma(t_),
                                                     rel=DET)


def cap_lbfgs(monkeypatch, iterations):
    """Both packages' TraceFeatures fits stop after `iterations` L-BFGS
    iterations (in place of 500)."""
    from stpy_tpu.opt.lbfgs import minimize_lbfgs as jl
    from stpy_tpu_torch.opt.lbfgs import minimize_lbfgs as tl
    monkeypatch.setattr(jtf, "minimize_lbfgs",
                        lambda f, x0, max_iter: jl(f, x0, max_iter=iterations))
    monkeypatch.setattr(ttf, "minimize_lbfgs",
                        lambda f, x0, max_iter: tl(f, x0, max_iter=iterations))


@pytest.mark.parametrize("psd", [False, True])
def test_trace_features_match_jax(psd, monkeypatch):
    """The JAX package's own case (tests/test_aux_components.py). The
    fits agree within 1e-6 over their first 50 L-BFGS iterations (1.5e-9
    measured). Past them both wander along directions the data do not fix
    (φφᵀ of 1-D points spans few of A's 36 entries), so the two
    500-iteration fits part at rounding's pace: A by 2.2e-5 (plain) and
    0.12 (PSD), the fitted values by 1.5e-7 and 4.2e-4 relative; the
    port's full fit is held to the JAX package's own bars and its
    variance, which does not depend on A, to the JAX one within 1e-10."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (50, 1))
    ej, et = JHermite(gamma=0.6, m=8, d=1), THermite(gamma=0.6, m=8, d=1,
                                                      **TK64)
    Phi = np.asarray(ej.embed(jnp.asarray(x)))
    A_true = np.diag([1.0] * 8) if psd else np.diag([1.0, -0.5] + [0.0] * 6)
    y = np.einsum("ij,jk,ik->i", Phi, A_true, Phi)[:, None]

    def fits():
        j = JTrace(embedding=ej, m=8, s=0.1, lam=0.01, PSD=psd)
        t = TTrace(embedding=et, m=8, s=0.1, lam=0.01, PSD=psd)
        j.fit_gp(x, y)
        t.fit_gp(x, y)
        return j, t

    with monkeypatch.context() as mp:
        cap_lbfgs(mp, 50)
        j, t = fits()
    assert rel(t.A, j.A) < ITER and rel(t.V, j.V) < DET
    outs = jax.jit(lambda z: (j.mean_std(z), j.band(z), j.band(
        z, maximization=False)))(jnp.asarray(x))
    for a, b in zip(t.mean_std(x), outs[0]):
        assert rel(a, b) < ITER
    assert rel(t.band(x), outs[1]) < ITER
    assert rel(t.band(x, maximization=False), outs[2]) < ITER
    sd_j = outs[0][1]
    t = TTrace(embedding=et, m=8, s=0.1, lam=0.01, PSD=psd)
    t.fit_gp(x, y)
    assert rel(t.mean_std(x)[1], sd_j) < DET
    if psd:
        assert np.linalg.eigvalsh(t.A.numpy()).min() > -1e-8
    else:
        assert np.abs(t.mean_std(x, std=False).numpy() - y).mean() < 0.1
