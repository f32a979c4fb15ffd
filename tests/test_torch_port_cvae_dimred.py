"""Port parity: stpy_tpu_torch/{generative_models/cvae, dimred,
feature_importance, sampling, viz}.py against stpy_tpu on the CPU, JAX in
x64 and torch in float64, the same numpy inputs from a seed.

`CVAE`: encode, decode and the ELBO on the JAX weights carried by
`convert.cvae_params_from_jax` (cast to float64 in both packages) within
1e-10, then one Adam epoch of three batches on the JAX package's own
permutation and reparameterisation draws (regenerated from its key and
fed to `cvae._permutation` / `_normal`), every weight within 1e-10
relative. `SRI`: eigenvalues within 1e-10, sign-aligned directions (and
the transform, the gradient design's directions) within 1e-8.
`FeatureRanker`: the one-off importance, and the permutation importance
on the JAX permutations, within 1e-10. `euler_maruyama`: one path on the
JAX draws within 1e-10, and the OU stationary variance of its own draws
within 5 % (as tests/test_misc_components.py holds the JAX one). `viz`:
every plot of the mixin renders headless under Agg.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu import sampling as jsamp
from stpy_tpu.dimred import SRI as JSRI
from stpy_tpu.feature_importance import FeatureRanker as JRanker
from stpy_tpu.generative_models import CVAE as JCVAE
from stpy_tpu.models import GaussianProcess as JGP
from stpy_tpu_torch import feature_importance as tfi
from stpy_tpu_torch import sampling as tsamp
from stpy_tpu_torch.convert import cvae_params_from_jax
from stpy_tpu_torch.dimred import SRI as TSRI
from stpy_tpu_torch.generative_models import cvae as tcv
from stpy_tpu_torch.models import GaussianProcess as TGP
from stpy_tpu_torch.models import KernelizedFeatures, OnlineGP
from stpy_tpu_torch.viz import RandomProcess

from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-10
FEAT, LATENT, COND, MID = 6, 2, 3, 16


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def cvae_data(n=40):
    rng = np.random.default_rng(3)
    labels = rng.integers(0, COND, n)
    X = (rng.uniform(size=(n, FEAT))
         < 0.2 + 0.6 * (labels[:, None] % 2)).astype(float)
    return X, np.eye(COND)[labels]


@pytest.fixture(scope="module")
def cvaes():
    """The JAX CVAE with its weights in float64, and the port's on them."""
    j = JCVAE(FEAT, LATENT, cond_size=COND, midsize=MID, seed=0)
    j.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), j.params)
    t = tcv.CVAE(FEAT, LATENT, cond_size=COND, midsize=MID, **F64)
    t.load_state_dict(cvae_params_from_jax(jax.tree.map(np.asarray,
                                                        j.params)))
    return j, t


def feed(monkeypatch, module, name, draws):
    it = iter(draws)
    monkeypatch.setattr(module, name, lambda *a: torch.as_tensor(
        np.array(next(it))))


def test_cvae_encode_decode_and_elbo_match_jax(cvaes, monkeypatch):
    j, t = cvaes
    X, Y = cvae_data()
    with torch.no_grad():
        mu, logvar = t.encode(torch.as_tensor(X), torch.as_tensor(Y))
        mj, lj = j.encode(j.params, jnp.asarray(X), jnp.asarray(Y))
        assert rel(mu, mj) < RTOL and rel(logvar, lj) < RTOL
        z = np.random.default_rng(1).standard_normal((40, LATENT))
        assert rel(t.decode(torch.as_tensor(z), torch.as_tensor(Y)),
                   j.decode(j.params, jnp.asarray(z), jnp.asarray(Y))) < RTOL
        key = jax.random.PRNGKey(7)
        feed(monkeypatch, tcv, "_normal",
             [jax.random.normal(key, (40, LATENT))])
        assert float(t.elbo_loss(torch.as_tensor(X), torch.as_tensor(Y))) \
            == pytest.approx(float(j.elbo_loss(j.params, key, jnp.asarray(X),
                                               jnp.asarray(Y))), rel=RTOL)
    # the port's own initialisation is flax's: zero biases, weights within
    # two of their standard deviations sqrt(1/fan_in)/0.8796
    fresh = tcv.CVAE(FEAT, LATENT, cond_size=COND, midsize=MID, **F64)
    w = fresh.enc.hidden.weight.detach()
    std = (1.0 / (FEAT + COND)) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert float(fresh.enc.hidden.bias.detach().abs().max()) == 0.0


def test_cvae_adam_epoch_matches_jax(cvaes, monkeypatch):
    j, t = cvaes
    X, Y = cvae_data()
    # the JAX fit's draws, regenerated from its key: a permutation, then a
    # normal draw per batch of 16
    key, perm_key = jax.random.split(j.key)
    draws = [np.asarray(jax.random.permutation(perm_key, 40))]
    noise = []
    for b in (16, 16, 8):
        key, sub = jax.random.split(key)
        noise.append(jax.random.normal(sub, (b, LATENT)))
    feed(monkeypatch, tcv, "_permutation", draws)
    feed(monkeypatch, tcv, "_normal", noise)
    j.fit(X, Y, epochs=1, batch=16, lr=1e-2)
    t.fit(X, Y, epochs=1, batch=16, lr=1e-2)
    sd = cvae_params_from_jax(jax.tree.map(np.asarray, j.params))
    for name, p in t.state_dict().items():
        assert rel(p, sd[name]) < RTOL, name
    g = torch.Generator().manual_seed(0)
    monkeypatch.undo()
    s = t.sample(Y[:1], size=5, generator=g)
    assert s.shape == (5, FEAT) and float(s.min()) >= 0 and float(
        s.max()) <= 1


def test_sri_matches_jax():
    rng = np.random.default_rng(7)
    X = rng.standard_normal((300, 4))
    beta = np.array([1.0, -0.5, 0.0, 0.25])
    y = np.tanh(X @ beta) + 0.05 * rng.standard_normal(300)
    j, t = JSRI(), TSRI(**F64)
    dj, wj = j.fit_sri(jnp.asarray(X), y)
    dt, wt = t.fit_sri(X, y)
    assert rel(wt, wj) < RTOL
    # each direction up to the eigensolvers' sign
    sign = np.sign(np.sum(np.asarray(dt) * np.asarray(dj), axis=0))
    assert rel(dt.numpy() * sign, dj) < 1e-8
    assert rel(t.transform(X, k=2) * torch.as_tensor(sign[:2]),
               j.transform(jnp.asarray(X), k=2)) < 1e-8
    G = rng.standard_normal((50, 4))
    (Vt, et), (Vj, ej) = t.gradient_design(4, 2, G), j.gradient_design(4, 2,
                                                                       G)
    assert rel(et, ej) < RTOL
    assert rel(np.abs(np.sum(Vt.numpy() * np.asarray(Vj), axis=0)),
               np.ones(2)) < 1e-8


def test_feature_ranker_matches_jax(monkeypatch):
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (60, 3))
    y = np.sin(3 * x[:, :1])
    jg, tg = JGP(gamma=0.5, s=0.1, d=3), TGP(gamma=0.5, s=0.1, d=3, **F64)
    jg.fit_gp(jnp.asarray(x), jnp.asarray(y))
    tg.fit_gp(x, y)
    jr, tr = JRanker(jg, x, y), tfi.FeatureRanker(tg, x, y)
    one = tr.one_off_importance()
    assert rel(one, jr.one_off_importance()) < RTOL
    assert one[0] > one[1] and one[0] > one[2]
    key, perms = jr.key, []
    for _ in range(3 * 2):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, 60)))
    feed(monkeypatch, tfi, "_permutation", perms)
    assert rel(tr.importance(repeats=2), jr.importance(repeats=2)) < RTOL


def test_euler_maruyama_matches_jax_and_its_ou_statistics(monkeypatch):
    key = jax.random.PRNGKey(3)
    x0 = np.linspace(-1, 1, 5)
    xs_j = jsamp.euler_maruyama(key, lambda x: -x, lambda x: 0.5,
                                jnp.asarray(x0), dt=0.01, steps=50)
    keys = jax.random.split(key, 50)
    feed(monkeypatch, tsamp, "_normal",
         [jax.random.normal(k, (5,), jnp.float64) for k in keys])
    xs_t = tsamp.euler_maruyama(None, lambda x: -x, lambda x: 0.5,
                                torch.as_tensor(x0), dt=0.01, steps=50)
    assert rel(xs_t, xs_j) < RTOL
    monkeypatch.undo()
    # dx = −x dt + √2 dW: stationary variance 1 (Euler's 1/(1 − dt/2))
    g = torch.Generator().manual_seed(0)
    xs = tsamp.euler_maruyama(g, lambda x: -x, lambda x: 2.0 ** 0.5,
                              np.zeros(8000), dt=0.01, steps=1000)
    assert xs.shape == (1000, 8000) and xs.device == torch.device("cpu")
    assert abs(float(xs[-1].var()) - 1.0 / (1 - 0.005)) < 0.05
    assert abs(float(xs[-1].mean())) < 4 / 8000 ** 0.5


def test_viz_mixin_renders_headless(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert issubclass(TGP, RandomProcess)
    assert issubclass(KernelizedFeatures, RandomProcess)
    assert issubclass(OnlineGP, RandomProcess)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (20, 1))
    gp = TGP(gamma=0.5, s=0.05, d=1, **F64)
    gp.fit_gp(x, np.sin(3 * x))
    xt = np.linspace(-1, 1, 50)[:, None]
    gp.visualize(xt, f_true=lambda v: np.sin(3 * v), show=False)
    gp.visualize_function(xt, lambda v: np.sin(3 * v), show=False)
    plt.savefig(tmp_path / "gp1.png")
    plt.close("all")
    x2 = rng.uniform(-1, 1, (30, 2))
    gp2 = TGP(gamma=0.5, s=0.05, d=2, **F64)
    gp2.fit_gp(x2, np.sin(3 * x2[:, :1]))
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 10),
                                np.linspace(-1, 1, 10)), -1).reshape(-1, 2)
    gp2.visualize(grid, show=False)
    plt.close("all")
    gp2.visualize_contour(grid, show=False)
    gp2.visualize_quiver(grid[:12], show=False)
    plt.savefig(tmp_path / "gp2.png")
    plt.close("all")
    assert (tmp_path / "gp1.png").exists() and (tmp_path / "gp2.png").exists()
