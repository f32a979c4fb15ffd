"""Frank-Wolfe and exponentiated-gradient steps on the simplex.

Port of stpy_tpu/opt/frank_wolfe.py. The JAX package scans the steps in
one `lax.scan` and differentiates `fun` with `jax.grad`; here the steps are
a Python loop of tensor ops on x0's device, the gradient comes from
autograd, or from `grad` where the caller has a closed form. The JAX scan
evaluates `fun` after every step and returns the last value; the port
evaluates it once, after the last step, which is the same value.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device


def frank_wolfe_step(grad, x, t):
    """FW over the simplex: move toward the best vertex with rate 2/(t+2)."""
    vertex = torch.zeros_like(x)
    vertex[torch.argmin(grad)] = 1.0
    gamma = 2.0 / (t + 2.0)
    return (1.0 - gamma) * x + gamma * vertex


def exponentiated_gradient_step(grad, x, eta):
    """Mirror-descent (entropic) step on the simplex."""
    logw = torch.log(torch.clamp(x, min=1e-30)) - eta * grad
    logw = logw - torch.max(logw)
    w = torch.exp(logw)
    return w / torch.sum(w)


def _autograd(fun):
    def g(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(fun(xg), xg)
        return gx
    return g


def minimize_on_simplex(fun, x0, steps=300, eta=0.1, method="eg", grad=None,
                        device=None):
    """Minimize `fun` over the probability simplex: (x, fun(x)) after
    `steps` steps. `grad(x)`, where given, replaces autograd's gradient of
    `fun`; `device` places an x0 that is not a tensor yet."""
    if not isinstance(x0, torch.Tensor):
        x0 = as_tensor(x0, device=resolve_device(device), dtype=torch.float64)
    g = grad if grad is not None else _autograd(fun)
    x = x0.detach()
    for t in range(steps):
        if method == "eg":
            x = exponentiated_gradient_step(g(x), x, eta)
        else:
            x = frank_wolfe_step(g(x), x, float(t))
    with torch.no_grad():
        return x, fun(x)
