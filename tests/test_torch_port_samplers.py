"""Port parity: the posterior samplers (stpy_tpu_torch/inference) and
`PoissonRateEstimator.sample` against stpy_tpu on the CPU, on the same
draws.

The JAX package runs each chain over keys split from the caller's key
(`_scan_chain`: one key a step; MLA′ splits each step's key into `inner`;
HMC splits each step's key into the momentum's and the acceptance
uniform's). The test regenerates those draws with `jax.random.split`,
`normal` and `uniform` exactly as the JAX package makes them and feeds
them, in order, to the port's draw helpers (`langevin._normal`,
`hmc._uniform`). Then the chains agree, JAX in x64 and torch in float64,
to 1e-8 relative over 50 steps (HMC 20 steps of 10 leapfrog steps), for
every sampler on a Gaussian target with a box, and for every `sampling=`
route of the estimator on the JAX fit's state, held in w = Γ^{1/2}θ where
the chains run (the sampled paths and bands, through Γ^{-1/2}, to 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.inference import hmc as jhmc
from stpy_tpu.inference import langevin as jl
from stpy_tpu_torch.convert import load_rate_estimator_state
from stpy_tpu_torch.inference import hmc as thmc
from stpy_tpu_torch.inference import langevin as tl
from stpy_tpu_torch.linalg import power_iteration

from test_torch_port_poisson import make_pair, rel
from torch_threads import one_torch_thread  # noqa: F401

jax.config.update("jax_enable_x64", True)

RTOL = 1e-8
STEPS = 50


def chain_draws(key, steps, shape, inner=None):
    """The normals `_scan_chain` draws: one a step from split(key, steps),
    or `inner` a step from split(step key, inner)."""
    out = []
    for k in jax.random.split(key, steps):
        subs = [k] if inner is None else jax.random.split(k, inner)
        out += [np.asarray(jax.random.normal(s, shape, jnp.float64))
                for s in subs]
    return out


def hmc_draws(key, steps, shape):
    out = []
    for k in jax.random.split(key, steps):
        k1, k2 = jax.random.split(k)
        out.append(("n", np.asarray(jax.random.normal(k1, shape, jnp.float64))))
        out.append(("u", np.asarray(jax.random.uniform(k2, (), jnp.float64))))
    return out


def feed(monkeypatch, draws):
    """The port's draw helpers return `draws` in order ("n" normals, "u"
    uniforms, or plain arrays for normals)."""
    it = iter(draws)

    def take(kind):
        def draw(_generator, like):
            d = next(it)
            if isinstance(d, tuple):
                assert d[0] == kind, d[0]
                d = d[1]
            return torch.as_tensor(np.array(d), dtype=like.dtype).reshape(
                like.shape if kind == "n" else ())
        return draw

    monkeypatch.setattr(tl, "_normal", take("n"))
    monkeypatch.setattr(thmc, "_normal", take("n"))
    monkeypatch.setattr(thmc, "_uniform", take("u"))
    return it


def target(m=4, seed=0):
    """A Gaussian target 0.5 (x − a)ᵀA(x − a) and a box [0, 2]."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((m, m))
    A = Q @ Q.T / m + np.eye(m)
    a = rng.uniform(0.5, 1.5, m)
    jA, ja = jnp.asarray(A), jnp.asarray(a)
    tA, ta = torch.tensor(A), torch.tensor(a)
    return (lambda x: jA @ (x - ja), lambda x: tA @ (x - ta), A, a,
            np.zeros(m), 2.0 * np.ones(m))


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


SAMPLERS = ["ula", "projected", "proximal", "mirror_box", "mirror_positive",
            "mla_prime", "newton"]


@pytest.mark.parametrize("name", SAMPLERS)
def test_langevin_chains_match_jax_on_the_same_draws(name, monkeypatch):
    jg, tg, A, a, l, u = target()
    m, key = A.shape[0], jax.random.PRNGKey(5)
    x0 = np.full(m, 0.7)
    eta = 0.05
    inner = 4 if name == "mla_prime" else None
    it = feed(monkeypatch, chain_draws(key, STEPS, (m,), inner))
    jl_, jx0 = jnp.asarray(l), jnp.asarray(x0)
    if name == "ula":
        J = jl.ula(key, jg, jx0, steps=STEPS, step_size=eta)
        T = tl.ula(None, tg, t(x0), steps=STEPS, step_size=eta)
    elif name == "projected":
        J = jl.projected_langevin(key, jg, lambda x: jnp.clip(x, 0.0, 2.0),
                                  jx0, steps=STEPS, step_size=eta)
        T = tl.projected_langevin(None, tg, lambda x: torch.clamp(x, 0.0, 2.0),
                                  t(x0), steps=STEPS, step_size=eta)
    elif name == "proximal":
        J = jl.proximal_langevin(key, jg, lambda x, s: jnp.clip(x, 0.0, 2.0),
                                 jx0, steps=STEPS, step_size=eta)
        T = tl.proximal_langevin(None, tg,
                                 lambda x, s: torch.clamp(x, 0.0, 2.0),
                                 t(x0), steps=STEPS, step_size=eta)
    elif name == "mirror_box":
        J = jl.mirror_langevin_box(key, jg, jl_, jnp.asarray(u), jx0,
                                   steps=STEPS, step_size=eta)
        T = tl.mirror_langevin_box(None, tg, t(l), t(u), t(x0), steps=STEPS,
                                   step_size=eta)
    elif name == "mirror_positive":
        J = jl.mirror_langevin_positive(key, jg, jl_, jx0, steps=STEPS,
                                        step_size=1e-3)
        T = tl.mirror_langevin_positive(None, tg, t(l), t(x0), steps=STEPS,
                                        step_size=1e-3)
    elif name == "mla_prime":
        J = jl.mla_prime_positive(key, jg, jl_, jx0, steps=STEPS,
                                  step_size=1e-3, inner=inner)
        T = tl.mla_prime_positive(None, tg, t(l), t(x0), steps=STEPS,
                                  step_size=1e-3, inner=inner)
    else:
        jA, tA = jnp.asarray(A), t(A)
        J = jl.newton_langevin(key, jg, lambda x: jA, jx0, steps=STEPS,
                               step_size=0.5)
        T = tl.newton_langevin(None, tg, lambda x: tA, t(x0), steps=STEPS,
                               step_size=0.5)
    assert next(it, None) is None            # every draw was used
    assert rel(T, J) < RTOL
    # burn-in and thinning slice the same iterates
    assert T.shape == (STEPS, m)


def test_hmc_matches_jax_on_the_same_draws(monkeypatch):
    _, _, A, a, *_ = target()
    m, key = A.shape[0], jax.random.PRNGKey(6)
    jA, ja, tA, ta = jnp.asarray(A), jnp.asarray(a), t(A), t(a)
    feed(monkeypatch, hmc_draws(key, 20, (m,)))
    J, jrate = jhmc.hmc_sample(
        key, lambda x: -0.5 * (x - ja) @ (jA @ (x - ja)), jnp.zeros(m),
        steps=20, leapfrog_steps=10, step_size=0.1)
    T, trate = thmc.hmc_sample(
        None, lambda x: -0.5 * (x - ta) @ (tA @ (x - ta)), torch.zeros(
            m, dtype=torch.float64), steps=20, leapfrog_steps=10,
        step_size=0.1)
    assert rel(T, J) < RTOL and float(trate) == float(jrate)
    assert 0 < float(trate) <= 1


def test_power_iteration_and_the_sampler_classes(monkeypatch):
    _, tg, A, a, l, u = target()
    assert float(power_iteration(t(A))) == pytest.approx(
        float(np.linalg.eigvalsh(A)[-1]), rel=1e-6)
    m = A.shape[0]
    feed(monkeypatch, [np.zeros(m)] * 30)
    vg = (lambda x: (0.5 * (x - t(a)) @ (t(A) @ (x - t(a))), tg(x)))
    x = tl.LangevinSampler().sample(None, vg, t(np.zeros(m)), steps=30)
    # without noise ULA at 1/(2L) is gradient descent toward a
    assert float(torch.linalg.vector_norm(x - t(a))) < 0.5
    feed(monkeypatch, [np.zeros(m)] * 10)
    x = tl.MirrorLangevin().sample(None, vg, t(l), t(u), t(np.ones(m)),
                                   steps=10, step_size=0.1)
    assert bool(((x > 0) & (x < 2)).all())
    feed(monkeypatch, [np.zeros(m)] * 10)
    x = tl.ProximalLangevin().sample(None, vg, lambda z, s: z.clamp(0, 2),
                                     t(np.zeros(m)), steps=10, L=float(
                                         np.linalg.eigvalsh(A)[-1]))
    assert x.shape == (m,)


# the explicit routes at a step of 1e-12: their chains are stable only
# under 2/λmax(∇²nll) ≈ 8e-9 here (λmax 2.4e8 at the fit), where the
# reference's default 1/m² = 3.9e-3 drives every moved coordinate to a
# bound in a step and scales rounding by ~1e6 a step (ROADMAP Queue 3);
# Newton (preconditioned) at its default; HMC at a leapfrog step of 1e-5
# (at its default 1e-3 every proposal is rejected and the chain stays)
ROUTES = [("mirror", 1e-12), ("hessian", 1e-12), ("mla_prime", 1e-12),
          ("newton", None), ("proximal+prox", 1e-12), ("projected", 1e-12),
          ("hmc", 1e-5)]


@pytest.fixture(scope="module")
def fitted():
    J, T, jh, th = make_pair()
    J.fit_gp()
    load_rate_estimator_state(T, rate=np.asarray(J.rate))
    return J, T, th


@pytest.mark.parametrize("route,stepsize", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_estimator_sample_routes_match_jax(fitted, route, stepsize,
                                           monkeypatch):
    """Each route's chain runs in w = Γ^{1/2}θ: its end point is held
    there (θ = Γ^{-1/2}w carries w's rounding times Γ^{1/2}'s condition
    number, 1.2e5 here)."""
    J, T, th = fitted
    m = T.get_m()
    for E in (J, T):
        E.sampling, E.steps, E.stepsize = route, STEPS, stepsize
    J.key = jax.random.PRNGKey(23)
    key, sub = jax.random.split(J.key)
    if route == "hmc":
        draws = hmc_draws(sub, max(STEPS // 10, 20), (m,))
    else:
        draws = chain_draws(sub, STEPS, (m,),
                            64 if route == "mla_prime" else None)
    it = feed(monkeypatch, draws)
    tj = J.sample()
    tt = T.sample()
    assert next(it, None) is None
    G = T.cov()
    w0 = G @ T.rate
    wj, wt = G @ torch.as_tensor(np.array(tj)), G @ tt
    assert float((wt - w0).abs().max()) > 1e-6       # the chain moved
    assert rel(wt, wj) < RTOL, route
    x = th.top_node.return_discretization(3)
    assert rel(T.sample_path_points(x),
               J.sample_path_points(jnp.asarray(x.numpy()))) < 1e-6


def test_sampled_bands_match_jax(fitted, monkeypatch):
    J, T, th = fitted
    m = T.get_m()
    for E in (J, T):
        E.sampling, E.steps, E.stepsize = "proximal+prox", 10, 1e-12
    J.key = jax.random.PRNGKey(23)
    key, draws = J.key, []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws += chain_draws(sub, 10, (m,))
    feed(monkeypatch, draws)
    x = th.top_node.return_discretization(4)
    lj, uj = J.sampled_lcb_ucb(jnp.asarray(x.numpy()), samples=3)
    lt, ut = T.sampled_lcb_ucb(x, samples=3)
    assert rel(lt, lj) < 1e-6 and rel(ut, uj) < 1e-6
    with pytest.raises(NotImplementedError, match="not supported"):
        T.sampling = "nope"
        T.sample()
