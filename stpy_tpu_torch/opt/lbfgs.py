"""Quasi-Newton and damped-Newton minimisers for small parameter vectors.

Port of stpy_tpu/opt/lbfgs.py: `LBFGSResult`, `minimize_lbfgs` with the
`"zoom"` (strong Wolfe, the default), `"backtracking"` and `"batched"` line
searches, `minimize_newton_small` and the two bijectors. The JAX package
builds its L-BFGS on optax (`scale_by_lbfgs`, `scale_by_zoom_linesearch`,
`scale_by_backtracking_linesearch`); the card has no optax, so
`_LBFGSMemory`, `_Zoom` and `_Backtracking` compute what those transforms
compute (optax 0.2.6), in plain torch.

PyTorch runs eagerly, so each `lax.while_loop` is a Python loop that reads
its stop test on the host, and the JAX package's `vmap` over candidate
steps is a loop over the candidates, largest first, value only and without
autograd. It stops at the first candidate that passes the Armijo test: the
JAX package takes the largest passing step, so the step is the same.
`fun` maps a 1-D tensor to a scalar tensor and is differentiable by
autograd; the iterates keep x0's dtype and device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

_C1 = 1e-4   # Armijo constant of the batched search and of Newton's guard


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    value: torch.Tensor
    iterations: int
    converged: bool


def _value(fun, x) -> torch.Tensor:
    with torch.no_grad():
        return fun(x).detach()


def _value_and_grad(fun, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        f = fun(xg)
        (g,) = torch.autograd.grad(f, xg)
    return f.detach(), g


def _stop_test(tol, rtol, xtol):
    """The shared stop rule: ‖g‖ ≤ tol, or ‖g‖ ≤ rtol·(1 + |f|), or
    ‖Δx‖_∞ ≤ xtol·(1 + ‖x‖_∞) (the last two only where set > 0)."""

    def done(x, gnorm, val, dx) -> bool:
        if gnorm <= tol:
            return True
        if rtol > 0.0 and gnorm <= rtol * (1.0 + abs(val)):
            return True
        return xtol > 0.0 and dx <= xtol * (1.0 + float(x.abs().max()))

    return done


class _LBFGSMemory:
    """optax.scale_by_lbfgs (scale_init_precond=True): a ring of the last
    `memory_size` parameter and gradient differences, and the two-loop
    product of Nocedal & Wright's Algorithm 7.4. `precondition(g, x)`
    records (x, g) and returns +H⁻¹g, as optax does (its update)."""

    def __init__(self, x: torch.Tensor, memory_size: int):
        m = memory_size
        self.m = m
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dparams = x.new_zeros((m,) + tuple(x.shape))
        self.dupdates = x.new_zeros((m,) + tuple(x.shape))
        self.rho = x.new_zeros(m)

    def precondition(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        m, zero = self.m, g.new_zeros(())
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dp, du = x - self.params, g - self.updates
            vdot = torch.dot(du, dp)
            weight = torch.where(vdot == 0.0, zero, 1.0 / vdot)
            den = torch.dot(du, du)
            scale = torch.where(den > 0.0, torch.dot(du, dp) / den,
                                torch.ones_like(den))
        else:
            dp, du, weight = torch.zeros_like(x), torch.zeros_like(g), zero
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        self.dparams[prev], self.dupdates[prev], self.rho[prev] = dp, du, weight
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.dot(self.dparams[i], vec)
            vec = vec - alphas[i] * self.dupdates[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.dupdates[i], vec)
            vec = vec + (alphas[i] - beta) * self.dparams[i]
        self.count += 1
        self.params, self.updates = x, g
        return vec


class _Backtracking:
    """optax.scale_by_backtracking_linesearch(max_backtracking_steps,
    store_grad=True) with its defaults (slope_rtol 1e-4, decrease 0.8,
    increase 1.5, max step 1, atol = rtol = 0). Holds the accepted point's
    value and gradient for the next iteration, as
    optax.value_and_grad_from_state reads them."""

    def __init__(self, x: torch.Tensor, max_steps: int):
        self.max_steps = max_steps
        self.lr = x.new_tensor(1.0)
        self.value = x.new_tensor(math.inf)
        self.grad = torch.zeros_like(x)

    def value_and_grad(self, fun, x):
        if bool(torch.isfinite(self.value)):
            return self.value, self.grad
        return _value_and_grad(fun, x)

    def step(self, fun, x, u, value, grad) -> torch.Tensor:
        """The scaled update lr·u."""
        slope = torch.dot(u, grad)
        lr = torch.clamp(1.5 * self.lr, max=1.0)
        new_value, new_grad = value, torch.zeros_like(x)
        error = x.new_tensor(math.inf)
        it = 0
        while not bool(error <= 0.0) and it <= self.max_steps:
            if it > 0:
                lr = 0.8 * lr
            xn = x + lr * u
            new_value = _value(fun, xn)
            error = new_value - value - lr * _C1 * slope
            error = torch.clamp(torch.where(torch.isnan(error),
                                            torch.full_like(error, math.inf),
                                            error), min=0.0)
            if bool(error <= 0.0) or it == self.max_steps:
                new_value, new_grad = _value_and_grad(fun, xn)
            it += 1
        self.lr = torch.where(torch.isinf(error), torch.zeros_like(lr), lr)
        self.value, self.grad = new_value, new_grad
        return self.lr * u


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa) with slope fpa at a,
    (b, fb) and (c, fc); NaN where it has none (optax's `_cubicmin`)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    u, v = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * u - db ** 2 * v) / denom
    B = (-(dc ** 3) * u + db ** 3 * v) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa) with slope fpa
    at a and (b, fb) (optax's `_quadmin`)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Zoom:
    """optax.scale_by_zoom_linesearch(max_linesearch_steps,
    initial_guess_strategy="one") with its defaults (slope_rtol 1e-4,
    curv_rtol 0.9, approx_dec_rtol 1e-6, increase factor 2, stepsize
    precision 1e-5, tol 0, no maximal step): Nocedal & Wright's Algorithms
    3.5 (bracketing) and 3.6 (zoom by cubic, else quadratic, else bisection
    interpolation) with Hager & Zhang's approximate-Wolfe decrease test.
    Where it fails (out of steps, or an interval under the precision with
    a sufficient decrease seen), it takes the best step of sufficient
    decrease, else the last step tried (none where every step left the
    domain). The scalars of the search are float64 numpy scalars read on
    the host (NaN propagates as in jnp); the points keep x's dtype. Holds
    the accepted point's value and gradient for the next iteration."""

    SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
    INCREASE, INTERVAL_THRESHOLD = 2.0, 1e-5

    def __init__(self, x: torch.Tensor, max_steps: int):
        self.max_steps = max_steps
        self.value = x.new_tensor(math.inf)
        self.grad = torch.zeros_like(x)

    value_and_grad = _Backtracking.value_and_grad

    def _decrease_error(self, step, value, slope, value0, slope0):
        err = value - value0 - self.SLOPE_RTOL * step * slope0
        approx = np.maximum(
            slope - (2 * self.SLOPE_RTOL - 1.0) * slope0,
            value - value0 - self.APPROX_DEC_RTOL * np.abs(value0))
        err = np.maximum(np.minimum(approx, err), 0.0)
        return np.float64(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope, slope0):
        err = np.maximum(np.abs(slope) - self.CURV_RTOL * np.abs(slope0), 0.0)
        return np.float64(np.inf) if np.isnan(err) else err

    def step(self, fun, x, u, value, grad) -> torch.Tensor:
        """The scaled update η·u."""
        f64 = np.float64

        def on_line(eta):
            v, g = _value_and_grad(fun, x + eta * u)
            return f64(v), g, f64(torch.dot(g, u))

        value0 = f64(value)
        slope0 = f64(torch.dot(u, grad))
        # the state of the search: the last step tried, the bracket
        # [low, high] and the cubic's third point, the best safe step
        eta, val, slope, g_eta = f64(0.0), value0, slope0, grad
        low, v_low, s_low = f64(0.0), value0, slope0
        high, v_high, s_high = f64(0.0), value0, slope0
        cref, v_cref = f64(0.0), value0
        safe, v_safe, g_safe = f64(0.0), value0, grad
        dec = f64(np.inf)
        found = done = failed = False
        count = 0
        with np.errstate(all="ignore"):
            while not (done or failed):
                if not found:
                    # Algorithm 3.5: grow the step until it brackets one
                    new = f64(1.0) if count == 0 else self.INCREASE * eta
                    v_new, g_new, s_new = on_line(new)
                    dec = self._decrease_error(new, v_new, s_new, value0,
                                               slope0)
                    err = np.maximum(dec, self._curvature_error(s_new, slope0))
                    if dec <= 0.0:
                        safe, v_safe, g_safe = new, v_new, g_new
                    to_high = bool(dec > 0.0) or (
                        bool(v_new >= val) and count > 0)
                    to_low = bool(s_new >= 0.0) and not to_high
                    if to_low:
                        low, v_low, s_low = new, v_new, s_new
                        high, v_high, s_high = eta, val, slope
                    else:
                        low, v_low, s_low = eta, val, slope
                        high, v_high, s_high = new, v_new, s_new
                    found = to_high or to_low or bool(err <= 0.0)
                    done = bool(err <= 0.0)
                    failed = count + 1 >= self.max_steps and not done
                    cref, v_cref = low, v_low
                else:
                    # Algorithm 3.6: interpolate inside the bracket
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    too_small = bool(delta <= self.INTERVAL_THRESHOLD)
                    mid_c = _cubicmin(low, v_low, s_low, high, v_high, cref,
                                      v_cref)
                    mid_q = _quadmin(low, v_low, s_low, high, v_high)
                    if (mid_c > left + 0.2 * delta) and (
                            mid_c < right - 0.2 * delta):
                        new = mid_c
                    elif (mid_q > left + 0.1 * delta) and (
                            mid_q < right - 0.1 * delta):
                        new = mid_q
                    else:
                        new = (low + high) / 2.0
                    v_new, g_new, s_new = on_line(new)
                    dec = self._decrease_error(new, v_new, s_new, value0,
                                               slope0)
                    err = np.maximum(dec, self._curvature_error(s_new, slope0))
                    if dec <= 0.0 and v_new < v_safe:
                        safe, v_safe, g_safe = new, v_new, g_new
                    done = bool(err <= 0.0)
                    to_high = bool(dec > 0.0) or bool(v_new >= v_low)
                    high_to_low = bool(s_new * (high - low) >= 0.0) \
                        and not to_high
                    old_low, old_vlow, old_slow = low, v_low, s_low
                    if to_high or high_to_low:
                        cref, v_cref = high, v_high
                    else:
                        cref, v_cref = low, v_low
                    if to_high:
                        high, v_high, s_high = new, v_new, s_new
                    if high_to_low:
                        high, v_high, s_high = old_low, old_vlow, old_slow
                    if not to_high:
                        low, v_low, s_low = new, v_new, s_new
                    failed = (count + 1 >= self.max_steps
                              or (too_small and safe > 0.0)) and not done
                eta, val, slope, g_eta = new, v_new, s_new, g_new
                count += 1
                if failed and (safe > 0.0 or np.isinf(dec)):
                    # the best step of sufficient decrease, if any
                    eta, val, g_eta = safe, v_safe, g_safe
        self.value = x.new_tensor(float(val))
        self.grad = g_eta
        return x.new_tensor(float(eta)) * u


def minimize_lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iter: int = 200,
    tol: float = 1e-8,
    memory_size: int = 10,
    linesearch: str = "zoom",
    rtol: float = 0.0,
    xtol: float = 0.0,
    max_linesearch_steps: int = 30,
    step_clip: float | None = None,
) -> LBFGSResult:
    """Minimise `fun` from x0 (stpy_tpu/opt/lbfgs.py:minimize_lbfgs).

    linesearch="zoom" (the default): optax's L-BFGS with its strong-Wolfe
    zoom line search, which keeps optax's 20 steps whatever
    `max_linesearch_steps` says, as in the JAX package; "backtracking":
    with optax's sufficient-decrease backtracking (max_linesearch_steps);
    "batched": `_minimize_lbfgs_batched_ls`.

    step_clip: iterates are clipped to [−step_clip, step_clip] after every
    step (the saturation guard of the sigmoid box reparameterisation).

    Stopping: ‖g‖ ≤ tol, or ‖g‖ ≤ rtol·(1 + |f|), or
    ‖Δx‖_∞ ≤ xtol·(1 + ‖x‖_∞); rtol and xtol are off at 0."""
    if linesearch == "batched":
        return _minimize_lbfgs_batched_ls(
            fun, x0, max_iter=max_iter, tol=tol, memory_size=memory_size,
            rtol=rtol, xtol=xtol, max_linesearch_steps=max_linesearch_steps,
            step_clip=step_clip)
    done = _stop_test(tol, rtol, xtol)
    memory = _LBFGSMemory(x0, memory_size)
    if linesearch == "backtracking":
        search = _Backtracking(x0, max_linesearch_steps)
    else:
        # optax.lbfgs's own line search: the caller's step count does not
        # reach it (stpy_tpu/opt/lbfgs.py:81)
        search = _Zoom(x0, 20)
    x, it = x0.detach(), 0
    gnorm, val, dx = math.inf, float(_value(fun, x0)), math.inf
    while it < max_iter and not done(x, gnorm, val, dx):
        value, grad = search.value_and_grad(fun, x)
        u = -memory.precondition(grad, x)
        step = search.step(fun, x, u, value, grad)
        dx = float(step.abs().max())
        x = x + step
        if step_clip is not None:
            x = torch.clamp(x, -step_clip, step_clip)
        gnorm, val, it = float(torch.linalg.vector_norm(grad)), float(value), it + 1
    vf = _value(fun, x)
    return LBFGSResult(x=x, value=vf, iterations=it,
                       converged=done(x, gnorm, float(vf), dx))


def _minimize_lbfgs_batched_ls(
    fun, x0, *, max_iter, tol, memory_size, rtol, xtol,
    max_linesearch_steps, step_clip=None,
):
    """L-BFGS whose line search tries the steps η = 2^{−k},
    k < max_linesearch_steps, and takes the largest that passes Armijo
    (c1 = 1e-4) (stpy_tpu/opt/lbfgs.py:_minimize_lbfgs_batched_ls).

    The direction is −H⁻¹g from `_LBFGSMemory`, or −g where that has lost
    descent. Where no step passes, the best finite candidate is taken if it
    lowers f by more than 8·eps·(1 + |f|), the memory is reset (the next
    direction is steepest descent) and the step does not count toward
    xtol; two dead ends in a row stop the loop as converged."""
    done = _stop_test(tol, rtol, xtol)
    etas = 0.5 ** torch.arange(max_linesearch_steps, dtype=x0.dtype,
                               device=x0.device)
    eps = torch.finfo(x0.dtype).eps
    memory = _LBFGSMemory(x0, memory_size)
    x, it, fails = x0.detach(), 0, 0
    gnorm, val, dx = math.inf, float(_value(fun, x0)), math.inf
    while it < max_iter and fails < 2 and not done(x, gnorm, val, dx):
        f, g = _value_and_grad(fun, x)
        d = -memory.precondition(g, x)
        gd = torch.dot(g, d)
        if bool(gd >= 0.0):
            d, gd = -g, -torch.dot(g, g)
        eta, best, best_eta = None, None, None
        for e in etas:
            c = _value(fun, x + e * d)
            if not bool(torch.isfinite(c)):
                continue
            if bool(c <= f + _C1 * e * gd):
                eta = e
                break
            if best is None or bool(c < best):
                best, best_eta = c, e
        any_ok = eta is not None
        greedy = best is not None and bool(
            best < f - 8 * eps * (1.0 + torch.abs(f)))
        if not any_ok:
            eta = best_eta if greedy else torch.zeros_like(f)
        x_new = x + eta * d
        if step_clip is not None:
            x_new = torch.clamp(x_new, -step_clip, step_clip)
        if not any_ok:
            # the memory is stale: the next direction is steepest descent
            memory = _LBFGSMemory(x_new, memory_size)
        gnorm = float(torch.linalg.vector_norm(g))
        # dx is the movement after the clip, and no dead end counts as one
        dx = float((x_new - x).abs().max()) if any_ok else math.inf
        fails = 0 if any_ok or greedy else fails + 1
        x, val, it = x_new, float(f), it + 1
    vf = _value(fun, x)
    return LBFGSResult(x=x, value=vf, iterations=it,
                       converged=done(x, gnorm, float(vf), dx) or fails >= 2)


def minimize_newton_small(
    fun, x0, *, max_iter=40, tol=1e-8, rtol=0.0, xtol=0.0, n_candidates=6,
):
    """Damped Newton for a handful of parameters
    (stpy_tpu/opt/lbfgs.py:minimize_newton_small): the exact Hessian,
    reverse over reverse (two `torch.autograd.grad` passes with
    create_graph; forward mode cannot cross the hand Grams' autograd
    Functions), a Levenberg floor of 1e-6·max|H|, a steepest-descent
    fallback scaled to the Newton step where the step is not a descent
    direction, and an Armijo guard over the steps
    (1, 0.5, 0.25, 0.06, 0.01, 0.002)[:n_candidates]. Stops as
    `minimize_lbfgs`, or after three iterations in a row that lower f by no
    more than rtol·(1 + |f|) (1e-12 where rtol is 0)."""
    done = _stop_test(tol, rtol, xtol)
    d = x0.shape[0]
    etas = [1.0, 0.5, 0.25, 0.06, 0.01, 0.002][:n_candidates]
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    x, it, stall = x0.detach(), 0, 0
    gnorm, f_prev, dx = math.inf, float(_value(fun, x0)), math.inf
    while it < max_iter and stall < 3 and not done(x, gnorm, f_prev, dx):
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            fv = fun(xg)
            (gg,) = torch.autograd.grad(fv, xg, create_graph=True)
            H = torch.stack([torch.autograd.grad(gg[i], xg, retain_graph=True)[0]
                             for i in range(d)])
        f, g = float(fv.detach()), gg.detach()
        improved = (f_prev - f) > (rtol if rtol > 0 else 1e-12) * (1.0 + abs(f))
        stall = 0 if improved else stall + 1
        scale = torch.clamp(H.abs().max(), min=1e-12)
        # solve_ex: a singular or NaN system gives inf/NaN, as
        # jnp.linalg.solve does, for the fallback below (solve raises on
        # the card)
        dstep = -torch.linalg.solve_ex(H + (1e-6 * scale) * eye, g).result
        gd = torch.dot(g, dstep)
        if not bool(torch.isfinite(gd)) or bool(gd >= 0.0):
            dstep = -g * (torch.linalg.vector_norm(dstep) / torch.clamp(
                torch.linalg.vector_norm(g), min=1e-30))
            gd = torch.dot(g, dstep)
        eta = 0.0
        for e in etas:
            c = _value(fun, x + e * dstep)
            if bool(torch.isfinite(c)) and bool(c <= f + _C1 * e * gd):
                eta = e
                break
        step = eta * dstep
        x = x + step
        gnorm, f_prev, dx = float(torch.linalg.vector_norm(g)), f, float(
            step.abs().max())
        it += 1
    vf = _value(fun, x)
    return LBFGSResult(x=x, value=vf, iterations=it,
                       converged=done(x, gnorm, float(vf), dx))


# -- smooth reparameterisations for constrained hyperparameters --------------

def make_positive_bijector(scale: float = 1.0):
    """raw -> positive via exp; inverse log. (Lengthscales, noise, κ.)"""
    return (lambda r: torch.exp(r) * scale), (lambda p: torch.log(p / scale))


def make_box_bijector(lo, hi):
    """raw -> (lo, hi) via a scaled sigmoid; stable inverse."""

    def fwd(r):
        return lo + (hi - lo) * torch.sigmoid(r)

    def inv(p):
        t = torch.clamp((p - lo) / (hi - lo), 1e-6, 1 - 1e-6)
        return torch.log(t) - torch.log1p(-t)

    return fwd, inv
