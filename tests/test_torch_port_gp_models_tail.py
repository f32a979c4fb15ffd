"""Port parity: stpy_tpu_torch/models/mixtures.py against
stpy_tpu/models/mixtures.py on the CPU.

The same numpy data (seeded) go through both packages, JAX in x64 and
torch in float64. The mixtures are fed the JAX package's own draws (the
Dirichlet weights, the categorical picks and the posterior normals,
regenerated from its key as it splits it) through the port's draw
helpers, and their samples agree within 1e-8 relative over 25 draws; the
evidences behind `map_model` within 1e-10. The cases are the JAX
package's own (tests/test_aux_components.py). `GammaContProcess` and
`TraceFeatures` are in tests/test_torch_port_trace_features.py,
`ConvexRKHS` in tests/test_torch_port_convex_rkhs.py.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.models import CategoricalMixture as JCat
from stpy_tpu.models import DirichletMixture as JDir
from stpy_tpu.models import GaussianProcess as JGP
from stpy_tpu_torch.embeddings import HermiteEmbedding as THermite
from stpy_tpu_torch.models import GammaContProcess as TGamma
from stpy_tpu_torch.models import GaussianProcess as TGP
from stpy_tpu_torch.models import TraceFeatures as TTrace
from stpy_tpu_torch.models import mixtures as tmx

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

DET = 1e-10
ITER = 1e-6
SAMPLER = 1e-8
F64 = jnp.float64
TK64 = {"device": "cpu", "dtype": torch.float64}


def rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def feed(monkeypatch, module, name, draws):
    it = iter(draws)
    monkeypatch.setattr(module, name, lambda *a, **k: next(it))


def mixture_data():
    """The JAX package's own data and test points; for the draws' parity,
    8 points past the data, where the posterior covariance is well
    conditioned (inside, its jittered factor carries cond·eps ≈ 1e-7 of
    the JAX package's own rounding)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (30, 1))
    return (x, np.sin(3 * x), np.linspace(-1, 1, 16)[:, None],
            np.linspace(1.5, 6.0, 8)[:, None])


def gps(GP, kw):
    return [GP(gamma=0.5, s=0.1, d=1, **kw), GP(gamma=2.0, s=0.1, d=1, **kw)]


def jax_draws(j, kind, xt, size, conc=None, probs=None):
    """The JAX mixture's `sample(xt, size)`: its loop over the key as it
    splits it, each draw's weights (`_draw_weights`) and posterior sample
    (`_mixed_posterior_sample`, under one `jax.jit`); with the weights
    and normals it drew, for the port's draw helpers."""
    post = jax.jit(j._mixed_posterior_sample)
    key, out, weights, normals = j.key, [], [], []
    for _ in range(size):
        key, s1 = jax.random.split(key)
        if kind == "dirichlet":
            a = jax.random.dirichlet(s1, jnp.asarray(conc, F64))
            weights.append(torch.tensor(np.asarray(a)))
        else:
            idx = jax.random.categorical(s1, jnp.log(jnp.asarray(probs, F64)))
            a = jnp.zeros(2, F64).at[idx].set(1.0)
            weights.append(int(idx))
        key, s2 = jax.random.split(key)
        normals.append(torch.tensor(np.asarray(
            jax.random.normal(s2, (xt.shape[0], 1), F64))))
        out.append(post(a, jnp.asarray(xt), s2))
    return np.concatenate([np.asarray(o) for o in out], axis=1), weights, \
        normals


@pytest.mark.parametrize("kind", ["dirichlet", "categorical"])
def test_mixture_samples_match_jax_on_the_same_draws(kind, monkeypatch):
    x, y, xt16, xt = mixture_data()
    conc, probs = np.array([0.7, 1.8]), np.array([0.35, 0.65])
    if kind == "dirichlet":
        j, m = JDir(gps(JGP, {}), concentration=conc), \
            tmx.DirichletMixture(gps(TGP, TK64), concentration=conc, **TK64)
    else:
        j, m = JCat(gps(JGP, {}), probs=jnp.asarray(probs)), \
            tmx.CategoricalMixture(gps(TGP, TK64), probs=probs, **TK64)
    j.fit_gp(x, y)
    m.fit_gp(x, y)
    assert rel(m.Ks, j.Ks) < DET
    want, weights, normals = jax_draws(j, kind, xt, 25, conc, probs)
    feed(monkeypatch, tmx, "_dirichlet" if kind == "dirichlet"
         else "_categorical", weights)
    feed(monkeypatch, tmx, "_normal", normals)
    assert rel(m.sample(xt, size=5), want[:, :5]) < SAMPLER
    mu, sd = m.mean_var(xt, N=20)
    assert rel(mu, want[:, 5:].mean(axis=1, keepdims=True)) < SAMPLER
    assert rel(sd, want[:, 5:].std(axis=1, keepdims=True)) < SAMPLER
    if kind == "categorical":
        ev_j, ev_t = [], []
        for pj, pt in zip(j.processes, m.processes):
            pj.x, pj.y, pt.x, pt.y = j.x, j.y, m.x, m.y
            ev_j.append(pj.log_marginal(pj.kernel_object, {}, 1.0))
            ev_t.append(pt.log_marginal(pt.kernel_object, {}, 1.0))
        assert rel(torch.stack(ev_t), jnp.stack(ev_j)) < DET
        # the JAX package's own case: the short lengthscale wins
        assert m.map_model() == j.map_model() == 0


def test_draw_helpers_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    conc = torch.tensor([0.4, 2.0, 5.0], dtype=torch.float64)
    w = torch.stack([tmx._dirichlet(gen, conc) for _ in range(3000)])
    assert torch.allclose(w.sum(dim=1), torch.ones(3000, dtype=torch.float64))
    assert np.allclose(w.mean(dim=0).numpy(), (conc / conc.sum()).numpy(),
                       atol=0.01)
    idx = [tmx._categorical(gen, torch.log(torch.tensor([0.2, 0.8])))
           for _ in range(2000)]
    assert abs(np.mean(idx) - 0.8) < 0.03


def test_models_default_to_the_card_and_never_the_cpu(monkeypatch):
    x, y, xt, _ = mixture_data()
    procs = gps(TGP, {"device": "cpu"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmx.DirichletMixture(procs),
                 lambda: TGamma(gamma=0.5, s=0.1, d=1),
                 lambda: TTrace(embedding=THermite(gamma=0.6, m=8, d=1), m=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    mix = tmx.DirichletMixture(procs, device="cpu")
    mix.fit_gp(x, y)
    mu, s = mix.mean_var(xt, N=4)
    assert mu.device.type == "cpu" and mu.dtype == torch.float32
    assert mu.shape == (16, 1) and bool(torch.isfinite(s).all())
