"""Hamiltonian Monte Carlo with leapfrog integration.

Port of stpy_tpu/inference/hmc.py. The JAX package scans the chain over
split keys; here it is a Python loop of tensor steps on x's device, each
step drawing its momentum (`langevin._normal`) and then its acceptance
uniform (`_uniform`) from a `torch.Generator`. `log_prob` maps a tensor
to a scalar tensor; its gradient comes from autograd.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.inference.langevin import _normal


def _uniform(generator, like):
    """One uniform of `like`'s dtype from `generator`, on `like`'s device."""
    where = like.device if generator is None else generator.device
    return torch.rand((), generator=generator, dtype=like.dtype,
                      device=where).to(like.device)


def _grad(log_prob):
    def g(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(log_prob(xg), xg)
        return gx
    return g


def hmc_sample(generator, log_prob, x0, steps=500, leapfrog_steps=20,
               step_size=1e-2, burn_in=0, thin=1):
    """Sample from exp(log_prob): (samples xs[burn_in::thin], acceptance
    rate)."""
    grad_lp = _grad(log_prob)

    def leapfrog(x, p):
        p = p + 0.5 * step_size * grad_lp(x)
        for _ in range(leapfrog_steps - 1):
            x = x + step_size * p
            p = p + step_size * grad_lp(x)
        x = x + step_size * p
        p = p + 0.5 * step_size * grad_lp(x)
        return x, -p

    x, n_acc, xs = x0, 0, []
    with torch.no_grad():
        for _ in range(steps):
            p = _normal(generator, x)
            x_new, p_new = leapfrog(x, p)
            h_old = -log_prob(x) + 0.5 * torch.sum(p * p)
            h_new = -log_prob(x_new) + 0.5 * torch.sum(p_new * p_new)
            accept = torch.log(_uniform(generator, x)) < h_old - h_new
            x = torch.where(accept, x_new, x)
            n_acc = n_acc + accept.to(torch.int32)
            xs.append(x)
    return torch.stack(xs)[burn_in::thin], n_acc / steps


class HmcSampler:
    def __init__(self, log_prob, leapfrog_steps=20, step_size=1e-2):
        self.log_prob = log_prob
        self.leapfrog_steps = leapfrog_steps
        self.step_size = step_size

    def sample(self, generator, x0, steps=500, burn_in=100):
        xs, _ = hmc_sample(generator, self.log_prob, x0, steps=steps,
                           leapfrog_steps=self.leapfrog_steps,
                           step_size=self.step_size, burn_in=burn_in)
        return xs
