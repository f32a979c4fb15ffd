"""Alias module of the reference's `sampling` package layout: the port of
stpy_tpu/sampling.py. The Langevin samplers live in
`stpy_tpu_torch.inference`; `euler_maruyama` integrates an SDE."""

import torch

from stpy_tpu_torch.inference.langevin import (  # noqa: F401
    LangevinSampler,
    MirrorLangevin,
    ProximalLangevin,
    mirror_langevin_box,
    projected_langevin,
    proximal_langevin,
    ula,
)


def _normal(generator, like):
    """Standard normals of `like`'s shape and dtype from `generator`, on
    `like`'s device."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def euler_maruyama(generator, drift, diffusion, x0, dt=1e-3, steps=1000):
    """Euler–Maruyama for dx = drift(x) dt + diffusion(x) dW from x0, the
    increments drawn from `generator`; returns the `steps` states after
    x0, shape (steps, *x0.shape). A tensor x0 stays on its device, anything
    else goes to the generator's."""
    x = (x0 if isinstance(x0, torch.Tensor)
         else torch.as_tensor(x0, device=generator.device))
    xs = torch.empty((steps, *x.shape), dtype=x.dtype, device=x.device)
    sq = dt ** 0.5
    for i in range(steps):
        x = x + drift(x) * dt + diffusion(x) * sq * _normal(generator, x)
        xs[i] = x
    return xs
