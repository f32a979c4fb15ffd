"""Matrix-free evidence (log-marginal) value and gradients, BBMM style, and
the hyperparameter fits built on them.

Port of stpy_tpu/parallel/bbmm.py. The fused tier: for
A(θ) = Σ_a κ_a·K̃_a(γ_a) + σ²I, a sum of fused atoms (SE / ARD / Matérn
ν ∈ {½, 3/2, 5/2}, each optionally on a coordinate group):

    ∂NLL/∂θ = −½ αᵀ(∂A/∂θ)α + ½ tr(A⁻¹ ∂A/∂θ),   α = A⁻¹y,

α by CG, the trace by Rademacher probes solved in one block CG, the NLL's
log-determinant by SLQ. A scalar lengthscale's ∂A/∂γ is the "dk_sq" shape
of the matrix-free products, (−2/γ)·κk'(sq)·sq; an ARD lengthscale
decomposes sq per coordinate over the "dk" shape κk'(sq), one block
product of d + 1 columns for the quadratic term and of probes·(2d + 1) for
the trace (ops/gram_matvec.py: csrc/gram_matvec.cu and csrc/gram_matmat.cu
on the card). The gradients are the exact formulas evaluated with
stochastic trace estimation, not autodiff through CG.

The JAX package compiles one program per static configuration
(`_evg_core`, an `lru_cache` of `jit`s); PyTorch runs eagerly and needs
none. Its `jax.random` keys become one `torch.Generator` per evidence call
(default: a fresh one on x's device, seeded with 0), drawn on its own
device in a fixed order: the preconditioner's landmarks, the probe block Z,
then SLQ's probes; a fit seeds each step's generator, on x's device, from
its `seed` and the step, as `fold_in(key, step)` does.

The general tier (`evidence_value_and_grad_general`, `fit_evidence_general`)
serves any kernel the port builds (products, Laplace, algebra): the same
identities, with the ∂A terms from autograd through a surrogate over the
row-chunked Gram (parallel/lazy_kernel.make_chunked_matmat, checkpointed
per chunk: O(n·chunk) memory), i.e. through the hand Grams' autograd
Functions.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from stpy_tpu_torch.config import as_tensor, resolve_device
from stpy_tpu_torch.ops.gram import _as_factor, gram_scaled
from stpy_tpu_torch.ops.gram_matvec import gram_matmat, gram_matvec
from stpy_tpu_torch.parallel.iterative import (
    cg_solve, cg_solve_block, rayleigh_nystrom_precond,
)
from stpy_tpu_torch.parallel.slq import rademacher, slq_logdet

def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The generator of one step of a fit, on `device` (the card unless
    the caller passes another): seeded from (seed, step) through numpy's
    SeedSequence, the port's `fold_in(key, step)`."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(state))


def _is_vec(gamma) -> bool:
    return isinstance(gamma, torch.Tensor) and gamma.dim() > 0


# ---------------------------------------------------------------------------
# per-atom gradient pieces
# ---------------------------------------------------------------------------

def _atom_quad_gamma(xa, alpha, gamma, kappa, family, nu):
    """−½ αᵀ(∂A/∂γ)α for one atom; scalar γ -> scalar, (d,) γ -> (d,)."""
    if not _is_vec(gamma):
        dv = (-2.0 / gamma) * gram_matvec(
            xa, xa, alpha, family=family, gamma=gamma, kappa=kappa, nu=nu,
            deriv=True)
        return -0.5 * (alpha @ dv)
    g = _as_factor(gamma, xa)
    xs = xa / g
    Va = torch.cat([alpha[:, None], alpha[:, None] * xs], dim=1)
    U = gram_matmat(xa, xa, Va, family=family, gamma=g, kappa=kappa, nu=nu,
                    shape="dk")                          # κ·k'(sq) block
    t1 = torch.einsum("i,id,i->d", alpha, xs * xs, U[:, 0])
    t2 = torch.einsum("id,id->d", alpha[:, None] * xs, U[:, 1:])
    bracket = 2.0 * t1 - 2.0 * t2        # αᵀ(κk'∘sq_c)α, symmetry-folded
    return -0.5 * (-2.0 / g) * bracket


def _atom_trace_gamma(xa, W, Z, gamma, kappa, family, nu):
    """tr(A⁻¹ ∂A/∂γ) estimated as mean_p w_pᵀ(∂A/∂γ)z_p for one atom."""
    r = Z.shape[1]
    if not _is_vec(gamma):
        dAZ = (-2.0 / gamma) * gram_matmat(
            xa, xa, Z, family=family, gamma=gamma, kappa=kappa, nu=nu,
            shape="dk_sq")
        return torch.mean(torch.sum(W * dAZ, dim=0))
    g = _as_factor(gamma, xa)
    xs = xa / g
    n, d = xs.shape
    V = torch.cat([Z] + [Z * xs[:, c:c + 1] for c in range(d)]
                  + [Z * xs[:, c:c + 1] ** 2 for c in range(d)], dim=1)
    U = gram_matmat(xa, xa, V, family=family, gamma=g, kappa=kappa, nu=nu,
                    shape="dk")                          # (n, r(2d + 1))
    U0 = U[:, :r]
    U1 = U[:, r:r * (1 + d)].reshape(n, d, r)
    U2 = U[:, r * (1 + d):].reshape(n, d, r)
    t1 = torch.einsum("ip,id,ip->d", W, xs * xs, U0)
    t2 = torch.einsum("ip,id,idp->d", W, xs, U1)
    t3 = torch.einsum("ip,idp->d", W, U2)
    return (-2.0 / g) * (t1 - 2.0 * t2 + t3) / r


# ---------------------------------------------------------------------------
# sum-of-fused-atoms evidence
# ---------------------------------------------------------------------------

def _sum_cross_gram(xs_atoms, desc, gammas, kappas, idx):
    """K[:, idx] of A's kernel part Σ_a κ_a K_a: the (n, r) landmark cross
    Gram of the Nyström preconditioner, by the Gram kernel (csrc/gram.cu on
    the card), whose shape functions are the matrix-free products'."""
    C = None
    for (fam, nu, _), xa, g, k in zip(desc, xs_atoms, gammas, kappas):
        xs = xa / _as_factor(g, xa)
        Ca = gram_scaled(xs, xs[idx], float(k), fam, nu)
        C = Ca if C is None else C + Ca
    return C


def _evidence_body_sum(x, yv, gammas, kappas, noise, generator, *, desc,
                       probes, lanczos_iters, cg_tol, cg_maxiter,
                       compute_value, probe_tol, probe_maxiter, precond_rank):
    n = yv.shape[0]
    xs_atoms = [x if grp is None
                else x[:, torch.as_tensor(grp, device=x.device)]
                for (_, _, grp) in desc]

    def Av(v):
        v = v.reshape(-1)
        out = (noise * noise) * v
        for (fam, nu, _), xa, g, k in zip(desc, xs_atoms, gammas, kappas):
            out = out + gram_matvec(xa, xa, v, family=fam, gamma=g, kappa=k,
                                    nu=nu)
        return out

    def Amm(V):
        out = (noise * noise) * V
        for (fam, nu, _), xa, g, k in zip(desc, xs_atoms, gammas, kappas):
            out = out + gram_matmat(xa, xa, V, family=fam, gamma=g, kappa=k,
                                    nu=nu)
        return out

    M_inv = None
    if precond_rank > 0:
        # landmark-sketch Rayleigh EVD (iterative.rayleigh_nystrom_precond)
        r = int(min(precond_rank, n))
        idx = torch.randperm(n, generator=generator,
                             device=generator.device)[:r].to(x.device)
        C = _sum_cross_gram(xs_atoms, desc, gammas, kappas, idx)
        M_inv = rayleigh_nystrom_precond(C, Amm, noise)

    # the probe block, drawn before SLQ's so that it does not depend on
    # compute_value
    Z = rademacher(n, probes, generator, yv.dtype, yv.device)

    alpha, _, _ = cg_solve(Av, yv, M_inv=M_inv, tol=cg_tol,
                           maxiter=cg_maxiter)

    # value: ½ yᵀα + ½ logdet (SLQ, the probes as one block) + (n/2) log 2π;
    # gradient steps can skip it (compute_value=False)
    if compute_value:
        ld, _ = slq_logdet(Av, n, probes=probes, lanczos_iters=lanczos_iters,
                           generator=generator, dtype=yv.dtype,
                           device=yv.device, matmat=Amm)
        nll = 0.5 * yv @ alpha + 0.5 * ld + 0.5 * n * math.log(2.0 * math.pi)
    else:
        nll = torch.tensor(float("nan"), dtype=yv.dtype, device=yv.device)

    # probe solves shared across every θ: one block CG
    Wz, _ = cg_solve_block(Amm, Z, M_inv=M_inv, tol=probe_tol,
                           maxiter=probe_maxiter)

    g_gammas, g_kappas = [], []
    for (fam, nu, _), xa, g, k in zip(desc, xs_atoms, gammas, kappas):
        q_g = _atom_quad_gamma(xa, alpha, g, k, fam, nu)
        t_g = _atom_trace_gamma(xa, Wz, Z, g, k, fam, nu)
        g_gammas.append(q_g + 0.5 * t_g)
        # κ: ∂A/∂κ = K̃ (κ = 1)
        Kz = gram_matmat(xa, xa, Z, family=fam, gamma=g, kappa=1.0, nu=nu)
        Ka = gram_matvec(xa, xa, alpha, family=fam, gamma=g, kappa=1.0, nu=nu)
        g_kappas.append(-0.5 * (alpha @ Ka)
                        + 0.5 * torch.mean(torch.sum(Wz * Kz, dim=0)))

    g_noise = (-0.5 * 2.0 * noise * (alpha @ alpha)
               + 0.5 * 2.0 * noise * torch.mean(torch.sum(Wz * Z, dim=0)))
    return nll, {"gammas": g_gammas, "kappas": g_kappas, "noise": g_noise}


def _data(x, y):
    """x and y as tensors: a tensor x keeps its device and dtype (y follows
    it), anything else goes to the card in float32."""
    if not isinstance(x, torch.Tensor):
        x = as_tensor(x, device=resolve_device(None))
    return x, as_tensor(y, device=x.device, dtype=x.dtype).reshape(-1)


def _hyper(v, like):
    """A hyperparameter as the body takes it: a vector (ARD γ) becomes a
    tensor of x's dtype on x's device, a scalar a float."""
    a = v.detach() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)
    if a.ndim > 0:
        return as_tensor(a, device=like.device, dtype=like.dtype)
    return float(a)


def evidence_value_and_grad_sum(
    x, y, desc, gammas, kappas, noise, *,
    probes=16, lanczos_iters=30, cg_tol=1e-6, cg_maxiter=500, generator=None,
    compute_value=True, probe_tol=None, probe_maxiter=100, precond_rank=0,
):
    """NLL and gradients for A = Σ_a κ_a K_a(γ_a) + σ²I over fused atoms.

    `desc` is a tuple of (family, nu, group|None) per atom; `gammas` a list
    of scalars or per-dim (ARD) vectors. Returns
    (nll, {"gammas": [...], "kappas": [...], "noise": g}), tensors on x's
    device; nll is NaN with compute_value=False.

    `precond_rank` > 0 builds a rank-r Rayleigh-Nyström preconditioner
    (fresh landmarks from `generator`, consistent with the current
    hyperparameters) for the alpha and probe CG solves.
    """
    x, yv = _data(x, y)
    g = (generator if generator is not None
         else torch.Generator(device=x.device).manual_seed(0))
    probe_tol = cg_tol if probe_tol is None else probe_tol
    desc = tuple((fam, float(nu), None if grp is None else tuple(grp))
                 for (fam, nu, grp) in desc)
    return _evidence_body_sum(
        x, yv, [_hyper(a, x) for a in gammas], [_hyper(k, x) for k in kappas],
        float(noise), g, desc=desc, probes=int(probes),
        lanczos_iters=int(lanczos_iters), cg_tol=float(cg_tol),
        cg_maxiter=int(cg_maxiter), compute_value=bool(compute_value),
        probe_tol=float(probe_tol), probe_maxiter=int(probe_maxiter),
        precond_rank=int(precond_rank))


def evidence_value_and_grad_lazy(
    x, y, gamma, kappa=1.0, noise=0.1, *, family="se", nu=1.5,
    probes=16, lanczos_iters=30, cg_tol=1e-6, cg_maxiter=500, generator=None,
    compute_value=True, probe_tol=None, probe_maxiter=100, precond_rank=0,
):
    """Single-atom `evidence_value_and_grad_sum`: the negative log evidence
    and its gradient in (gamma, kappa, noise) from matrix-free products
    only, O(n) memory; `gamma` a scalar or a per-dim (ARD) vector (its
    gradient then per dim). `probe_tol` loosens the probe CG against the
    alpha solve (default: cg_tol); `probe_maxiter` caps it.

    Returns (nll, {"gamma", "kappa", "noise"})."""
    nll, g = evidence_value_and_grad_sum(
        x, y, ((family, nu, None),), [gamma], [kappa], noise,
        probes=probes, lanczos_iters=lanczos_iters, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, generator=generator,
        compute_value=compute_value, probe_tol=probe_tol,
        probe_maxiter=probe_maxiter, precond_rank=precond_rank)
    return nll, {"gamma": g["gammas"][0], "kappa": g["kappas"][0],
                 "noise": g["noise"]}


# ---------------------------------------------------------------------------
# general-kernel evidence (chunked autograd surrogate)
# ---------------------------------------------------------------------------

def evidence_value_and_grad_general(
    kernel_object, x, y, params_dict=None, noise=0.1, *,
    chunk=2048, probes=16, lanczos_iters=30, cg_tol=1e-6, cg_maxiter=500,
    probe_tol=None, probe_maxiter=100, generator=None, compute_value=True,
    precond_rank=0,
):
    """Matrix-free evidence gradient for ANY KernelFunction (products,
    Laplace, algebra) in the whole params dict and the noise. α by PCG
    (the landmark `rayleigh_nystrom_precond` where precond_rank > 0), W by
    a block solve on Rademacher probes Z, then the surrogate

        −½ αᵀ(∂A)α + ½ mean_p w_pᵀ(∂A)z_p,   α, W, Z held fixed,

    whose autograd gradient in (params, σ) is the NLL's: one chunked
    product K(θ)·[α, Z] (`make_chunked_matmat`, checkpointed per chunk),
    its backward through the hand Grams' Functions. The value, where asked
    for, is ½yᵀα + ½ SLQ log det + (n/2) log 2π.

    `params_dict` (default: the kernel's) gives the point; its leaves are
    taken in x's dtype, as the JAX package casts them. Draws come from
    `generator` (default: a fresh one on x's device seeded with 0): the
    landmarks, then Z, then SLQ's probes. Returns
    (nll, {"params": {atom: {name: grad}}, "noise": g}), nll NaN with
    compute_value=False."""
    from stpy_tpu_torch.parallel.lazy_kernel import make_chunked_matmat

    x, yv = _data(x, y)
    n = yv.shape[0]
    gen = (generator if generator is not None
           else torch.Generator(device=x.device).manual_seed(0))
    probe_tol = cg_tol if probe_tol is None else probe_tol
    pd = params_dict if params_dict is not None else kernel_object.params_dict
    pd0 = {ak: {pk: as_tensor(v, device=x.device, dtype=x.dtype)
                for pk, v in sub.items()} for ak, sub in pd.items()}
    s0 = float(noise)
    mm = make_chunked_matmat(kernel_object, x, chunk=int(min(chunk, n)))

    def Amm(V):
        return mm(V, pd0) + (s0 * s0) * V

    def Av(v):
        return Amm(v.reshape(-1, 1))[:, 0]

    M_inv = None
    if precond_rank > 0:
        r = int(min(precond_rank, n))
        idx = torch.randperm(n, generator=gen, device=gen.device)[:r].to(
            x.device)
        C = kernel_object.eval_params(pd0, x, x[idx])            # (n, r)
        M_inv = rayleigh_nystrom_precond(C, Amm, s0)
    Z = rademacher(n, probes, gen, yv.dtype, yv.device)
    alpha, _, _ = cg_solve(Av, yv, M_inv=M_inv, tol=cg_tol,
                           maxiter=cg_maxiter)
    W, _ = cg_solve_block(Amm, Z, M_inv=M_inv, tol=probe_tol,
                          maxiter=probe_maxiter)

    # ∇surrogate = −½αᵀ(∂A)α + ½·mean_p w_pᵀ(∂A)z_p  (α, W, Z fixed)
    leaves = {ak: {pk: v.detach().clone().requires_grad_()
                   for pk, v in sub.items()} for ak, sub in pd0.items()}
    s_leaf = torch.tensor(s0, dtype=x.dtype, device=x.device,
                          requires_grad=True)
    flat = [v for sub in leaves.values() for v in sub.values()]
    with torch.enable_grad():
        KV = mm(torch.cat([alpha[:, None], Z], dim=1), leaves)
        s2 = s_leaf * s_leaf
        quad = -0.5 * (alpha @ KV[:, 0] + s2 * (alpha @ alpha))
        tr = 0.5 * (torch.mean(torch.sum(W * KV[:, 1:], dim=0))
                    + s2 * torch.mean(torch.sum(W * Z, dim=0)))
        grads = torch.autograd.grad(quad + tr, flat + [s_leaf],
                                    allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(flat + [s_leaf], grads)]
    it = iter(grads)
    g_params = {ak: {pk: next(it) for pk in sub} for ak, sub in leaves.items()}
    g_noise = next(it)
    if compute_value:
        ld, _ = slq_logdet(Av, n, probes=probes, lanczos_iters=lanczos_iters,
                           generator=gen, dtype=yv.dtype, device=yv.device,
                           matmat=Amm)
        nll = 0.5 * yv @ alpha + 0.5 * ld + 0.5 * n * math.log(2.0 * math.pi)
    else:
        nll = torch.tensor(float("nan"), dtype=yv.dtype, device=yv.device)
    return nll, {"params": g_params, "noise": g_noise}


# ---------------------------------------------------------------------------
# the full fits (host-side Adam in log space)
# ---------------------------------------------------------------------------

def _adam_log_space(value_grad_fn, theta0, steps, lr, tol, verbose,
                    names=None):
    """Log-space Adam over a dict of positive numpy arrays.
    `value_grad_fn(theta) -> {name: grad-array}` (plain dθ, not dlogθ).
    Stops once the EMA of the largest per-step |Δlog θ| is under `tol`
    (from step 5). Returns (theta, steps_run, history)."""
    theta = {k: np.asarray(v, np.float64) for k, v in theta0.items()}
    names = list(theta) if names is None else names
    m = {k: np.zeros_like(theta[k]) for k in names}
    v = {k: np.zeros_like(theta[k]) for k in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    ema = None
    history = []
    steps_run = 0
    for t in range(1, steps + 1):
        grads = value_grad_fn(theta)
        step_max = 0.0
        steps_run = t
        for k in names:
            g = np.asarray(grads[k], np.float64) * theta[k]  # chain to log
            m[k] = b1 * m[k] + (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * g * g
            mh = m[k] / (1 - b1**t)
            vh = v[k] / (1 - b2**t)
            dlog = lr * mh / (np.sqrt(vh) + eps)
            step_max = max(step_max, float(np.max(np.abs(dlog))))
            theta[k] = np.exp(np.log(theta[k]) - dlog)
        history.append(step_max)
        ema = step_max if ema is None else 0.7 * ema + 0.3 * step_max
        if verbose:
            print(f"step {t:3d}  max|dlog|={step_max:.3e}  "
                  + "  ".join(f"{k}={np.round(theta[k], 4)}" for k in names),
                  flush=True)
        if t >= 5 and ema < tol:
            break
    return theta, steps_run, history


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def fit_evidence_lazy(
    x, y, gamma0, kappa0=1.0, noise0=0.1, *, family="se", nu=1.5,
    optimize=("gamma", "noise"), steps=30, lr=0.1, probes=64,
    cg_tol=1e-5, cg_maxiter=300, probe_tol=1e-2, probe_maxiter=60,
    tol=1e-2, final_value=True, seed=0, verbose=False, precond_rank=0,
):
    """Hyperparameter fit on the matrix-free evidence: log-space Adam over
    any subset of (gamma, kappa, noise), each step one
    `evidence_value_and_grad_lazy` (compute_value=False) on the generator
    `step_generator(seed, step, x.device)`. `gamma0` may be a per-dim (ARD)
    vector, fitted per dim. Stop rule: the EMA of the largest per-step
    |Δlog θ| under `tol`.

    `final_value=True` closes with one SLQ evaluation at the fitted values
    (generator `step_generator(seed, 0, x.device)`); should it raise, the
    fit is still returned, with nll NaN, a warning, and the exception's
    repr in `nll_error`, as in the JAX package. Returns {gamma, kappa,
    noise, nll, nll_error, steps_run, history}."""
    g0 = np.asarray(_numpy(gamma0), np.float64)
    is_vec = g0.ndim > 0 and g0.size > 1
    theta0 = {"gamma": g0 if is_vec else float(g0),
              "kappa": float(kappa0), "noise": float(noise0)}
    names = [n_ for n_ in ("gamma", "kappa", "noise") if n_ in optimize]
    if not names:
        raise ValueError("optimize must name at least one of gamma/kappa/noise")
    x, yv = _data(x, y)
    step_counter = [0]

    def vg(theta):
        step_counter[0] += 1
        _, grads = evidence_value_and_grad_lazy(
            x, yv, theta["gamma"], float(theta["kappa"]),
            float(theta["noise"]), family=family, nu=nu, probes=probes,
            cg_tol=cg_tol, cg_maxiter=cg_maxiter,
            generator=step_generator(seed, step_counter[0], x.device),
            compute_value=False, probe_tol=probe_tol,
            probe_maxiter=probe_maxiter, precond_rank=precond_rank)
        return {k: _numpy(grads[k]) for k in names}

    theta, steps_run, history = _adam_log_space(vg, theta0, steps, lr, tol,
                                                verbose, names=names)
    out = {"gamma": (np.asarray(theta["gamma"]) if is_vec
                     else float(theta["gamma"])),
           "kappa": float(theta["kappa"]),
           "noise": float(theta["noise"])}
    nll = float("nan")
    nll_error = None
    if final_value:
        try:
            val, _ = evidence_value_and_grad_lazy(
                x, yv, out["gamma"], out["kappa"], out["noise"],
                family=family, nu=nu, probes=probes, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter,
                generator=step_generator(seed, 0, x.device),
                compute_value=True, probe_tol=probe_tol,
                probe_maxiter=probe_maxiter, precond_rank=precond_rank)
            nll = float(val)
        except Exception as e:  # noqa: BLE001 — the fitted values stand even
            # if the closing evaluation fails; the failure is reported
            nll_error = repr(e)
            warnings.warn(
                f"fit_evidence_lazy: closing SLQ evidence evaluation failed "
                f"({nll_error}); returning nll=nan", stacklevel=2)
    return {**out, "nll": nll, "nll_error": nll_error,
            "steps_run": steps_run, "history": history}


def fit_evidence_sum(
    x, y, desc, gammas0, kappas0, noise0, *,
    optimize=("gamma", "noise"), steps=30, lr=0.1, probes=64,
    cg_tol=1e-5, cg_maxiter=300, probe_tol=1e-2, probe_maxiter=60,
    tol=1e-2, seed=0, verbose=False, precond_rank=0,
):
    """Matrix-free hyperparameter fit for a sum of fused atoms (kernel
    algebra `k1 + k2`, each atom with its own γ_a, scalar or ARD vector,
    and κ_a), as `fit_evidence_lazy`. Returns {"gammas": [...],
    "kappas": [...], "noise": float, "steps_run", "history"}."""
    A = len(desc)
    theta0 = {"noise": float(noise0)}
    for a in range(A):
        g = np.asarray(_numpy(gammas0[a]), np.float64)
        theta0[f"gamma{a}"] = g if (g.ndim > 0 and g.size > 1) else float(g)
        theta0[f"kappa{a}"] = float(_numpy(kappas0[a]))
    names = []
    if "gamma" in optimize:
        names += [f"gamma{a}" for a in range(A)]
    if "kappa" in optimize:
        names += [f"kappa{a}" for a in range(A)]
    if "noise" in optimize:
        names += ["noise"]
    if not names:
        raise ValueError("optimize must name at least one of gamma/kappa/noise")
    x, yv = _data(x, y)
    step_counter = [0]

    def vg(theta):
        step_counter[0] += 1
        _, grads = evidence_value_and_grad_sum(
            x, yv, desc, [theta[f"gamma{a}"] for a in range(A)],
            [float(theta[f"kappa{a}"]) for a in range(A)],
            float(theta["noise"]), probes=probes, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter,
            generator=step_generator(seed, step_counter[0], x.device),
            compute_value=False, probe_tol=probe_tol,
            probe_maxiter=probe_maxiter, precond_rank=precond_rank)
        out = {"noise": _numpy(grads["noise"])}
        for a in range(A):
            out[f"gamma{a}"] = _numpy(grads["gammas"][a])
            out[f"kappa{a}"] = _numpy(grads["kappas"][a])
        return out

    theta, steps_run, history = _adam_log_space(vg, theta0, steps, lr, tol,
                                                verbose, names=names)
    return {"gammas": [theta[f"gamma{a}"] for a in range(A)],
            "kappas": [float(theta[f"kappa{a}"]) for a in range(A)],
            "noise": float(theta["noise"]),
            "steps_run": steps_run, "history": history}


_GAMMA_KEYS = {"gamma", "ard_gamma", "gamma_per_group", "ard_per_group"}


def fit_evidence_general(
    kernel_object, x, y, noise0=0.1, *,
    optimize=("gamma", "noise"), steps=30, lr=0.1, probes=32,
    chunk=2048, cg_tol=1e-5, cg_maxiter=300, probe_tol=1e-2,
    probe_maxiter=60, tol=1e-2, seed=0, verbose=False, precond_rank=0,
):
    """Matrix-free hyperfit for ANY KernelFunction: log-space Adam on
    `evidence_value_and_grad_general` (compute_value=False, generator
    `step_generator(seed, step, x.device)`) over every lengthscale leaf
    (gamma / ard_gamma / gamma_per_group / ard_per_group) when "gamma" ∈
    optimize, every kappa when "kappa" ∈ optimize, and the noise when
    "noise" ∈ optimize; other leaves stay fixed. Writes nothing back:
    returns {"params": fitted leaves as float64 tensors shaped like the
    kernel's, "noise": float, "steps_run", "history"}."""
    pd0 = kernel_object.params_dict
    flat, theta0 = {}, {}
    for ak, sub in pd0.items():
        for pk, val in sub.items():
            if not ((pk in _GAMMA_KEYS and "gamma" in optimize)
                    or (pk == "kappa" and "kappa" in optimize)):
                continue
            name = f"{ak}.{pk}"
            flat[name] = (ak, pk)
            v = np.asarray(_numpy(val), np.float64)
            theta0[name] = v if (v.ndim > 0 and v.size > 1) else float(v)
    if "noise" in optimize:
        theta0["noise"] = float(noise0)
    if not theta0:
        raise ValueError("nothing to optimize for this kernel/optimize set")
    x, yv = _data(x, y)

    def leaf(name, value):
        ak, pk = flat[name]
        ref = pd0[ak][pk]
        return torch.as_tensor(np.broadcast_to(np.asarray(value),
                                               tuple(ref.shape)).copy(),
                               dtype=torch.float64, device=ref.device)

    def theta_to_pd(theta):
        pd = {ak: dict(sub) for ak, sub in pd0.items()}
        for name, (ak, pk) in flat.items():
            pd[ak][pk] = leaf(name, theta[name])
        return pd

    step_counter = [0]

    def vg(theta):
        step_counter[0] += 1
        _, grads = evidence_value_and_grad_general(
            kernel_object, x, yv, theta_to_pd(theta),
            float(theta.get("noise", noise0)), chunk=chunk, probes=probes,
            cg_tol=cg_tol, cg_maxiter=cg_maxiter, probe_tol=probe_tol,
            probe_maxiter=probe_maxiter,
            generator=step_generator(seed, step_counter[0], x.device),
            compute_value=False, precond_rank=precond_rank)
        out = {}
        for name, (ak, pk) in flat.items():
            g = np.asarray(_numpy(grads["params"][ak][pk]), np.float64)
            t = np.asarray(theta[name])
            out[name] = g if t.shape == g.shape else np.sum(g)
        if "noise" in theta:
            out["noise"] = _numpy(grads["noise"])
        return out

    theta, steps_run, history = _adam_log_space(vg, theta0, steps, lr, tol,
                                                verbose)
    fitted = {ak: {} for ak in pd0}
    for name, (ak, pk) in flat.items():
        fitted[ak][pk] = leaf(name, theta[name])
    return {"params": fitted, "noise": float(theta.get("noise", noise0)),
            "steps_run": steps_run, "history": history}
