#!/usr/bin/env python3
"""Properties of the Poisson point-process solvers that the port shares
with the JAX package, measured on both on the CPU in float64 (JAX in
x64): the sources of ROADMAP Queue 3's "shared by both packages" entries
and of the choices tests/test_torch_port_{poisson,ellipsoid,samplers}.py
state.

    python3 tools/poisson_shared_faults.py

1. The anchor (dual) MAP route on tests/test_torch_port_poisson.py's 1-D
   rounds at 16, 32, 64 and 128 anchors: each package's objective at its
   own fit, and the coordinates of w = Γ^{1/2}θ each leaves on the box's
   upper bound.
2. The non-square elliptical slice at its default 150 steps on
   tests/test_torch_port_ellipsoid.py's problems (seeds 0-2, c = 0.3,
   0.6, 1.0): the largest relative change of its values when Σ is scaled
   by 1 + 1e-14.
0. The 1-D test model's Γ^{1/2} and Γ^{-1/2} (both packages' float64
   LAPACK chains): Γ^{1/2}'s condition number and each matrix's largest
   gap relative to its largest entry.
3. The estimator's explicit Langevin routes at the reference's step
   1/m² on the JAX fit's state, both packages on the same draws: the
   largest eigenvalue of the posterior's Hessian in w at the start, and
   the relative gap of the chains' end points in w after 10 and 50 steps.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
jax.config.update("jax_enable_x64", True)

from stpy_tpu.opt import ellipsoid as je  # noqa: E402
from stpy_tpu_torch.convert import load_rate_estimator_state  # noqa: E402
from stpy_tpu_torch.opt import ellipsoid as te  # noqa: E402

import test_torch_port_ellipsoid as tel  # noqa: E402
import test_torch_port_poisson as tpo  # noqa: E402
import test_torch_port_samplers as tsa  # noqa: E402


class _Patch:
    """A stand-in for pytest's monkeypatch: `setattr` for the run."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def basis_chain():
    J, T, *_ = tpo.make_pair(data=False)
    (Gj, Gij), (Gt, Git) = J.cov(inverse=True), T.cov(inverse=True)
    print(f"Γ^½: condition number {float(torch.linalg.cond(Gt))!r}, gap "
          f"{tpo.rel(Gt, Gj)!r}; Γ^-½ gap {tpo.rel(Git, Gij)!r}")


def anchors():
    for n in (16, 32, 64, 128):
        J, T, *_ = tpo.make_pair(dual=True, no_anchor_points=n)
        J.fit_gp()
        T.fit_gp()
        f = tpo.objective(T, "dual")
        G, u = T.cov(), float(T.B)
        wj, wt = G @ tpo._t(J.rate), G @ T.rate
        print(f"anchors {n}: objective JAX {float(f(tpo._t(J.rate)))!r}, "
              f"port {float(f(T.rate))!r}; coordinates of w on u: JAX "
              f"{int((wj > u - 1e-6).sum())}, port {int((wt > u - 1e-6).sum())}")


def _change(v1, v2):
    v1, v2 = np.asarray(v1), np.asarray(v2)
    return float(np.max(np.abs(v1 - v2) / np.maximum(np.abs(v1), 1e-3)))


def rectangular_slice():
    worst = {"port": 0.0, "JAX": 0.0}
    for seed in range(3):
        for c in (0.3, 0.6, 1.0):
            Sigma, mu, c, l, Lam, u, X = tel.problem(seed, c=c)
            Lam, l, u = tel.rectangular(Lam, l, u)
            gaps = {}
            t_args = (tel.t(mu), c, tel.t(l), tel.t(Lam), tel.t(u))
            gaps["port"] = _change(*(te.maximize_on_elliptical_slice(
                tel.t(X), tel.t(S), *t_args)[0].numpy()
                for S in (Sigma, Sigma * (1 + 1e-14))))
            j_args = (jnp.asarray(mu), c, jnp.asarray(l), jnp.asarray(Lam),
                      jnp.asarray(u))
            gaps["JAX"] = _change(*(jax.vmap(
                lambda x, S=S: je.maximize_on_elliptical_slice(
                    x, jnp.asarray(S), *j_args)[0])(jnp.asarray(X))
                for S in (Sigma, Sigma * (1 + 1e-14))))
            for k in worst:
                worst[k] = max(worst[k], gaps[k])
            print(f"non-square slice, seed {seed}, c {c}: largest relative "
                  f"change under Σ·(1 + 1e-14): {gaps}")
    print(f"non-square slice: worst {worst}")


def explicit_routes():
    J, T, *_ = tpo.make_pair()
    J.fit_gp()
    load_rate_estimator_state(T, rate=np.asarray(J.rate))
    grad, hess, l, u, G, _ = T._posterior_nll_grad()
    w0 = torch.clamp(G @ T.rate, l + 1e-3, u - 1e-3)
    lam = float(torch.linalg.eigvalsh(hess(w0)).max())
    m = T.get_m()
    print(f"posterior Hessian in w at the start: λmax {lam!r}, stable "
          f"explicit step under {2.0 / lam!r}; the default step 1/m² = "
          f"{1.0 / m ** 2!r}")
    for route in ("mirror", "hessian", "mla_prime", "proximal+prox",
                  "projected"):
        for steps in (10, 50):
            for E in (J, T):
                E.sampling, E.steps, E.stepsize = route, steps, None
            J.key = jax.random.PRNGKey(23)
            _, sub = jax.random.split(J.key)
            tsa.feed(_Patch(), tsa.chain_draws(
                sub, steps, (m,), 64 if route == "mla_prime" else None))
            tj, tt = J.sample(), T.sample()
            wj, wt = G @ tpo._t(tj), G @ tt
            print(f"{route}, {steps} steps at 1/m²: w relative gap "
                  f"{tpo.rel(wt, wj)!r}")


if __name__ == "__main__":
    basis_chain()
    anchors()
    rectangular_slice()
    explicit_routes()
