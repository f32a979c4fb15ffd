"""The Langevin family as chains of tensor steps.

Port of stpy_tpu/inference/langevin.py: `ula`, `projected_langevin`,
`proximal_langevin`, `mirror_langevin_box`, `mirror_langevin_positive`,
`mla_prime_positive`, `newton_langevin` and the sampler classes. The JAX
package runs each chain as one `lax.scan` over split keys; here a chain is
a Python loop of tensor steps on x's device, its normals drawn from a
`torch.Generator` (`_normal`: one draw of x's shape a step, `inner` draws
a step for MLA′). Each function returns the stacked iterates
xs[burn_in::thin], as the JAX package does; `grad_f` maps a tensor to
its gradient.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.linalg import chol_jittered, power_iteration


def _normal(generator, like):
    """Standard normals of `like`'s shape and dtype, from `generator`, on
    `like`'s device."""
    where = like.device if generator is None else generator.device
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=where).to(like.device)


def _chain(step_fn, x0, generator, steps, burn_in=0, thin=1):
    xs, x = [], x0
    for _ in range(steps):
        x = step_fn(x, generator)
        xs.append(x)
    return torch.stack(xs)[burn_in::thin]


def ula(generator, grad_f, x0, steps=500, step_size=None, lipschitz=None,
        burn_in=0, thin=1):
    """Unadjusted Langevin: x ← x − η∇f + √(2η) w, η = 1/(2L) by default."""
    eta = step_size if step_size is not None else 1.0 / (2.0 * lipschitz)

    def step(x, g):
        w = _normal(g, x)
        return x - eta * grad_f(x) + (2.0 * eta) ** 0.5 * w

    return _chain(step, x0, generator, steps, burn_in, thin)


def projected_langevin(generator, grad_f, project, x0, steps=500,
                       step_size=1e-3, burn_in=0, thin=1):
    """Projected Langevin: a projection after every step."""

    def step(x, g):
        w = _normal(g, x)
        return project(x - step_size * grad_f(x)
                       + (2.0 * step_size) ** 0.5 * w)

    return _chain(step, x0, generator, steps, burn_in, thin)


def proximal_langevin(generator, grad_f, prox, x0, steps=500,
                      step_size=1e-3, burn_in=0, thin=1):
    """Proximal Langevin: x ← prox_η(x − η∇f + √(2η) w)."""

    def step(x, g):
        w = _normal(g, x)
        return prox(x - step_size * grad_f(x) + (2.0 * step_size) ** 0.5 * w,
                    step_size)

    return _chain(step, x0, generator, steps, burn_in, thin)


def mirror_langevin_box(generator, grad_f, l, u, x0, steps=500,
                        step_size=1e-3, burn_in=0, thin=1, eps=1e-9):
    """Mirror Langevin on a box through the map y = logit((x − l)/(u − l)),
    the dual noise scaled by √φ''(x) = √(1/(x − l) + 1/(u − x))."""
    span = u - l

    def to_dual(x):
        t = torch.clamp((x - l) / span, eps, 1 - eps)
        return torch.log(t) - torch.log1p(-t)

    def to_primal(y):
        return l + span * torch.sigmoid(y)

    def step(y, g):
        x = to_primal(y)
        hess = (1.0 / torch.clamp(x - l, min=eps)
                + 1.0 / torch.clamp(u - x, min=eps))
        w = _normal(g, y)
        return y - step_size * grad_f(x) + torch.sqrt(
            2.0 * step_size * hess) * w

    return to_primal(_chain(step, to_dual(x0), generator, steps, burn_in,
                            thin))


def mirror_langevin_positive(generator, grad_f, b, x0, steps=500,
                             step_size=1e-3, burn_in=0, thin=1, eps=1e-10,
                             x_max=1e8):
    """Mirror Langevin with the map φ(x) = −Σ log(x − b) on {x > b}: the
    dual step z = −1/(x − b) − η∇f + √(2η)·w/(x − b), then x = b − 1/z."""

    def step(x, g):
        w = _normal(g, x)
        gap = torch.clamp(x - b, min=eps)
        z = -1.0 / gap - step_size * grad_f(x) + (
            2.0 * step_size) ** 0.5 * w / gap
        return b - 1.0 / torch.clamp(z, max=-1.0 / x_max)

    return _chain(step, torch.maximum(x0, b + eps), generator, steps,
                  burn_in, thin)


def mla_prime_positive(generator, grad_f, b, x0, steps=100, step_size=1e-3,
                       inner=64, burn_in=0, thin=1, eps=1e-10, x_max=1e8):
    """MLA′ on {x > b}: the mirror drift, then the dual diffusion
    dz = √2 |z| dB simulated by `inner` Euler substeps of η/inner, each
    z ← z·(1 + √(2δ) ξ)."""
    delta = step_size / inner

    def step(x, g):
        z = -1.0 / torch.clamp(x - b, min=eps) - step_size * grad_f(x)
        for _ in range(inner):
            z = z * (1.0 + (2.0 * delta) ** 0.5 * _normal(g, z))
        return b - 1.0 / torch.clamp(z, max=-1.0 / x_max)

    return _chain(step, torch.maximum(x0, b + eps), generator, steps,
                  burn_in, thin)


def newton_langevin(generator, grad_f, hess_f, x0, steps=200, step_size=1.0,
                    burn_in=0, thin=1):
    """Newton-Langevin, drift and noise preconditioned by the local
    Hessian H = L Lᵀ: x ← x − η H⁻¹∇f + √(η(2 − η))·L⁻ᵀw (the JAX
    package's two bias fixes of the reference)."""
    noise_scale = (step_size * (2.0 - step_size)) ** 0.5

    def step(x, g):
        w = _normal(g, x)
        L = chol_jittered(hess_f(x))
        drift = torch.cholesky_solve(grad_f(x)[:, None], L)[:, 0]
        noise = torch.linalg.solve_triangular(L.T, w[:, None], upper=True)[:, 0]
        return x - step_size * drift + noise_scale * noise

    return _chain(step, x0, generator, steps, burn_in, thin)


def _grad_of(value_and_grad_f):
    return lambda x: value_and_grad_f(x)[1]


class LangevinSampler:
    """ULA with the Lipschitz constant from power iteration on the
    Hessian (autograd's where none is given)."""

    def __init__(self, verbose=False):
        self.verbose = verbose

    def calculate(self, hessian_fn, x0):
        return power_iteration(hessian_fn(x0))

    def sample(self, generator, value_and_grad_f, x0, hessian_fn=None,
               steps=500, L=None):
        if L is None:
            L = self.calculate(
                hessian_fn if hessian_fn is not None else
                (lambda x: torch.autograd.functional.hessian(
                    lambda t: value_and_grad_f(t)[0], x)), x0)
        return ula(generator, _grad_of(value_and_grad_f), x0, steps=steps,
                   lipschitz=L)[-1]


class ProximalLangevin(LangevinSampler):
    def sample(self, generator, value_and_grad_f, prox, x0, steps=500, L=1.0):
        return proximal_langevin(generator, _grad_of(value_and_grad_f), prox,
                                 x0, steps=steps,
                                 step_size=1.0 / (2 * L))[-1]


class MirrorLangevin(LangevinSampler):
    def sample(self, generator, value_and_grad_f, l, u, x0, steps=500,
               step_size=1e-3):
        return mirror_langevin_box(generator, _grad_of(value_and_grad_f), l,
                                   u, x0, steps=steps,
                                   step_size=step_size)[-1]
