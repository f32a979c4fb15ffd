"""Exact Hamiltonian sampling for truncated multivariate Gaussians
(Pakman & Paninski): the Hamiltonian flow of a standard Gaussian is a
harmonic oscillator x(t) = x cos t + p sin t, so trajectories are computed
in closed form and linear constraints F x + g ≥ 0 are handled by exact
wall bounces at analytically computed hit times.

Port of stpy_tpu/inference/tmg.py. The JAX package runs a trajectory as a
`lax.while_loop` over at most `max_bounces` wall hits. Here a trajectory
is a loop of masked bounce steps: each step is computed, and kept only
while time is left and the bounce count is under `max_bounces`, which is
the while loop's own condition, so a finished trajectory stays as it
was. The host reads that condition once every `CHECK_EVERY` steps, not
once a step, and stops when the trajectory is done; on the card those
steps are captured in a CUDA graph and replayed (`_CapturedTrajectory`).
Each sample's momentum is drawn through `_normal` from a
`torch.Generator`.

A wall is hit only where the trajectory leaves the region through it,
and at once where it sits on the wall moving out (`_next_hit`). From
inside the region that is the JAX package's hit; it differs where a
trajectory ends on a wall, its hit time rounded to the time left: the
JAX package's next trajectory from there leaves the region when its
momentum points out (in chip_smoke.py phase 19.3's model, d = 32, a chain
under the JAX package's rule reached such a state at its 1850th draw, and
the trajectory from it ended 2.30 beyond a wall).

The whitening and the trajectories run in float64 whatever `dtype` asks,
and the samples are returned in `dtype`. In f32 the hit phase of the wall
a trajectory has just bounced off rounds to ~1e-7, above the 1e-9 guard
that is meant to skip it, so the trajectory bounces off it a second time
and leaves the region: the JAX package in f32 puts 0.6 % of the
coordinates of 400 samples in the 32-dimensional positive orthant below
−1e-6, down to −3.03.
"""

from __future__ import annotations

import math

import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.inference.langevin import _normal
from stpy_tpu_torch.linalg import safe_cholesky, tri_solve

_TWO_PI = 2.0 * math.pi
# masked bounce steps between two host reads of the trajectory's condition
CHECK_EVERY = 4


def _next_hit(x, p, F, g, t_eps):
    """Earliest time t < 2π at which the trajectory x cos t + p sin t leaves
    some wall f_jᵀx + g_j ≥ 0. Returns (t_hit, j_hit); t_hit = 2π if none.

    Each wall's value r cos(t + φ) + g_j falls through zero at its exit
    phase −φ + acos(−g_j/r) and rises through it at its entry phase
    −φ − acos(−g_j/r); from inside the region the exit comes first, so
    only exits are hits. A wall the particle sits on or beyond while
    moving out of it is hit at t = 0. (The JAX package takes the earlier
    of both phases and skips those under `t_eps`; a trajectory ending on a
    wall then leaves the region on its next draw.)"""
    a = F @ p  # (m,)
    b = F @ x
    r = torch.sqrt(a * a + b * b)
    active = r > torch.abs(g) + 1e-12  # wall reachable
    phi = torch.atan2(-a, b)  # x cos t + p sin t hits when cos(t+phi) = -g/r
    c = -g / torch.where(r > 0, r, torch.ones_like(r))
    acos = torch.arccos(torch.clamp(c, -1.0, 1.0))
    t_exit = torch.remainder(-phi + acos, _TWO_PI)
    two_pi = torch.full_like(t_exit, _TWO_PI)
    # grazing exits at a wall the particle has just bounced off round to
    # a few ulps; they are skipped as the JAX package skips its re-hits
    t_exit = torch.where(t_exit < t_eps, two_pi, t_exit)
    out_now = (b + g <= 0) & (a < 0)
    tj = torch.where(out_now, torch.zeros_like(t_exit),
                     torch.where(active, t_exit, two_pi))
    j = torch.argmin(tj).reshape(1)
    # index by gathers: a 0-dim index tensor would be read on the host
    return tj.index_select(0, j)[0], j


def _flow(x, p, t):
    return x * torch.cos(t) + p * torch.sin(t), p * torch.cos(t) - x * torch.sin(t)


def _masked_step(x, p, F, g, t_left, bounces, max_bounces):
    """One bounce step, kept only while time is left and the bounce count
    is under `max_bounces` (the JAX while loop's condition)."""
    live = (t_left > 1e-12) & (bounces < max_bounces)
    t_hit, j = _next_hit(x, p, F, g, t_eps=1e-9)
    t_step = torch.minimum(t_hit, t_left)
    x_new, p_new = _flow(x, p, t_step)
    f = F.index_select(0, j)[0]
    reflected = p_new - 2.0 * (f @ p_new) / torch.sum(f * f) * f
    p_new = torch.where(t_hit < t_left, reflected, p_new)
    return (torch.where(live, x_new, x), torch.where(live, p_new, p),
            torch.where(live, t_left - t_step, t_left),
            bounces + live.to(bounces.dtype))


def _one_trajectory(x, p, F, g, T, max_bounces=64):
    """Integrate the exact flow for total time T with wall bounces."""
    t_left = torch.as_tensor(T, dtype=x.dtype, device=x.device)
    bounces = torch.zeros((), dtype=torch.int64, device=x.device)
    for step in range(max_bounces):
        if step % CHECK_EVERY == 0 and not bool(t_left > 1e-12):
            break
        x, p, t_left, bounces = _masked_step(x, p, F, g, t_left, bounces,
                                             max_bounces)
    return x


class _CapturedTrajectory:
    """`_one_trajectory` on the card: CHECK_EVERY masked steps captured once
    in a CUDA graph and replayed until the trajectory is done, one host
    read a replay. A step is some fifty small kernels, so eagerly a
    d = 32 chain spends its time launching them; the replayed steps are
    the same kernels on the same buffers, so the trajectory is the eager
    one bit for bit."""

    def __init__(self, F, g, max_bounces):
        d = F.shape[1]
        self.F, self.g, self.max_bounces = F, g, max_bounces
        self.x = torch.zeros(d, dtype=F.dtype, device=F.device)
        self.p = torch.zeros_like(self.x)
        self.t_left = torch.zeros((), dtype=F.dtype, device=F.device)
        self.bounces = torch.zeros((), dtype=torch.int64, device=F.device)
        side = torch.cuda.Stream(device=F.device)
        side.wait_stream(torch.cuda.current_stream(F.device))
        with torch.cuda.stream(side):
            self._steps()              # warm up outside the capture
        torch.cuda.current_stream(F.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._steps()

    def _steps(self):
        x, p, t, b = self.x, self.p, self.t_left, self.bounces
        for _ in range(CHECK_EVERY):
            x, p, t, b = _masked_step(x, p, self.F, self.g, t, b,
                                      self.max_bounces)
        self.x.copy_(x)
        self.p.copy_(p)
        self.t_left.copy_(t)
        self.bounces.copy_(b)

    def __call__(self, x, p, T):
        self.x.copy_(x)
        self.p.copy_(p)
        self.t_left.fill_(T)
        self.bounces.zero_()
        for _ in range(-(-self.max_bounces // CHECK_EVERY)):
            self.graph.replay()
            if not bool(self.t_left > 1e-12):
                break
        return self.x.clone()


def tmg_sample(generator, n, mu, Sigma, F, g, x0, steps_per_sample=1,
               T=math.pi / 2, max_bounces=64, device=None,
               dtype=torch.float32):
    """Draw n samples from N(mu, Sigma) restricted to {x: F x + g ≥ 0},
    as a tensor of `dtype` on `device` (the card unless the caller passes
    another), computed in float64.

    x0 must be strictly feasible. Works in whitened coordinates
    z = L⁻¹(x - mu) where the target is standard normal."""
    dev = resolve_device(device)

    def t(v):
        return as_tensor(v, device=dev, dtype=torch.float64)

    mu = t(mu).reshape(-1)
    F, g = t(F), t(g)
    L = safe_cholesky(t(Sigma)).L
    Fw = F @ L
    gw = g + F @ mu
    z = tri_solve(L, (t(x0).reshape(-1) - mu)[:, None], lower=True)[:, 0]
    if z.is_cuda:
        trajectory = _CapturedTrajectory(Fw, gw, max_bounces)
    else:
        def trajectory(z, p, T):
            return _one_trajectory(z, p, Fw, gw, T, max_bounces)
    zs = []
    for _ in range(n * steps_per_sample):
        p = _normal(generator, z)
        z = trajectory(z, p, T)
        zs.append(z)
    zs = torch.stack(zs)[::steps_per_sample]
    return (zs @ L.T + mu).to(dtype)
