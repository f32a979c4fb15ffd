"""Stochastic Lanczos quadrature (SLQ): matvec-only log-determinant and
trace estimation, the scalable companion of CG inference.

Port of stpy_tpu/parallel/slq.py:

    log det(A) = tr(log A) ≈ (1/p) Σ_probes ‖z‖² e₁ᵀ log(T_z) e₁

where T_z is the Lanczos tridiagonal of A started at a Rademacher probe z.
The JAX package runs the Lanczos recurrence as a `lax.scan` and vmaps it
over the probes, one matvec per probe and step. Here the recurrence is a
Python loop over an (n, p) block whose columns are the probes, each with
its own coefficients, through a block product: `slq_logdet`'s `matmat`
(on the card one `gram_matmat` launch per kernel atom and step) or, by
default, `matvec` applied column by column; the same function either way,
with fewer launches the first. The Rademacher probes come from an explicit
`torch.Generator` and are drawn on its device (default: a fresh one on the
probes' device, seeded with 0). The tridiagonals' eigh runs in float64, as
`parallel.iterative._eigh64`.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.config import resolve_device


def rademacher(n, probes, generator, dtype, device):
    """An (n, probes) block of ±1 drawn from `generator` on the generator's
    own device, then moved to `device`."""
    bits = torch.randint(0, 2, (n, probes), generator=generator,
                         device=generator.device, dtype=dtype)
    return (2 * bits - 1).to(device=device, dtype=dtype)


def lanczos_tridiag(matvec, z, iters: int):
    """Lanczos from q₁ = z/‖z‖: returns (alphas (iters,), betas (iters-1,),
    ‖z‖) of the tridiagonal T with A ≈ Q T Qᵀ. Full orthogonalisation is
    skipped, as in the JAX package (standard for SLQ). A block z of shape
    (n, p) runs p independent recurrences, one per column, through a
    `matvec` that takes (n, p) blocks; the results then carry a trailing
    axis of p."""
    znorm = torch.linalg.vector_norm(z, dim=0)
    q = z / znorm
    q_prev = torch.zeros_like(q)
    beta = torch.zeros_like(znorm)
    alphas, betas = [], []
    for _ in range(iters):
        w = matvec(q)
        alpha = torch.sum(q * w, dim=0)
        w = w - alpha * q - beta * q_prev
        beta = torch.linalg.vector_norm(w, dim=0)
        q_prev, q = q, w / torch.clamp(beta, min=1e-30)
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas)[:-1], znorm


def _quadrature(alphas, betas, znorm, fn):
    """‖z‖² Σ τ f(w) for each probe: (w, V) the float64 eigenpairs of the
    tridiagonal (probes on the trailing axis), τ = V[0, :]²."""
    a = alphas.T.to(torch.float64)                     # (p, iters)
    b = betas.T.to(torch.float64)                      # (p, iters - 1)
    T = torch.diag_embed(a) + torch.diag_embed(b, 1) + torch.diag_embed(b, -1)
    w, V = torch.linalg.eigh(T)
    tau = V[:, 0, :] ** 2
    vals = znorm.to(torch.float64) ** 2 * torch.sum(tau * fn(w), dim=-1)
    return vals.to(alphas.dtype)


def _probe_values(matmat, n, fn, probes, lanczos_iters, generator, dtype,
                  device):
    """The per-probe quadratures of f: the probes go to `device`, else to
    the generator's, else to the card."""
    if device is None:
        device = (generator.device if generator is not None
                  else resolve_device(None))
    device = torch.device(device)
    g = (generator if generator is not None
         else torch.Generator(device=device).manual_seed(0))
    Z = rademacher(n, probes, g, dtype, device)
    return _quadrature(*lanczos_tridiag(matmat, Z, lanczos_iters), fn)


def _columns(matvec):
    """A block product made of one `matvec` per column."""
    return lambda Q: torch.stack([matvec(q) for q in Q.unbind(1)], dim=1)


def slq_logdet(matvec, n, probes=16, lanczos_iters=30, generator=None,
               dtype=torch.float32, device=None, matmat=None):
    """Estimate log det(A) for SPD A given only `matvec` (or, for all probes
    in one block product a step, `matmat`). Returns (estimate, per-probe
    values). The eigenvalues are clipped at 1e-30 before the log."""
    vals = _probe_values(
        matmat if matmat is not None else _columns(matvec), n,
        lambda w: torch.log(torch.clamp(w, min=1e-30)), probes,
        lanczos_iters, generator, dtype, device)
    return torch.mean(vals), vals


def slq_trace_fn(matvec, n, fn, probes=16, lanczos_iters=30, generator=None,
                 dtype=torch.float32):
    """tr(f(A)) for a scalar function `fn` (applied to float64 eigenvalue
    tensors) by the same machinery."""
    return torch.mean(_probe_values(_columns(matvec), n, fn, probes,
                                    lanczos_iters, generator, dtype, None))


def evidence_matvec_only(matvec, y, n, probes=16, lanczos_iters=30,
                         cg_tol=1e-8, cg_maxiter=500, generator=None):
    """Negative log evidence ½ yᵀ(K + σ²I)⁻¹y + ½ log det(K + σ²I) from
    matvecs only: CG for the solve, SLQ for the log-determinant (the JAX
    package's value leaves out the (n/2) log 2π term, and so does this)."""
    from stpy_tpu_torch.parallel.iterative import cg_solve

    yv = y.reshape(-1)
    alpha, _, _ = cg_solve(matvec, yv, tol=cg_tol, maxiter=cg_maxiter)
    ld, _ = slq_logdet(matvec, n, probes=probes, lanczos_iters=lanczos_iters,
                       generator=generator, dtype=yv.dtype, device=yv.device)
    return 0.5 * yv @ alpha + 0.5 * ld
