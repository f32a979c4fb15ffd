"""Ellipsoid-constrained maximizers: the inner problem of every per-action
UCB/LCB bound of the point-process stack.

Port of stpy_tpu/opt/ellipsoid.py. Problems solved:
  maximize_on_ellipsoid:        max xᵀθ  s.t. (θ−μ)ᵀΣ(θ−μ) ≤ c²
                                 → μ + c Σ⁻¹x / √(xᵀΣ⁻¹x)
  maximize_on_elliptical_slice: the same with a box l ≤ Λθ ≤ u: the closed
                                 form where it is feasible, else projected
                                 ascent in z = Λθ, the projection onto
                                 ellipsoid ∩ box by Dykstra's alternating
                                 projections, the ellipsoid's exactly by
                                 Newton on the secular equation.

The JAX package bounds a stack of actions by `jax.vmap` over this solve,
where `lax.cond(feasible, closed form, constrained)` becomes a select that
computes both branches for every action. Here the solvers take a batch:
`x` is one functional (m,) or a stack (A, m), every loop runs on all rows
at once as plain tensor code, and the constrained branch runs only on the
rows whose closed form leaves the box. Rows are independent, so each
row's value is the one the per-action solve gives. PyTorch runs eagerly:
the constrained branch launches each small op of its 150 × 25 × 40 loops
on its own, whatever the batch.

One departure: the constrained branches' decompositions (Λ⁻¹ and the
eigenbasis of Σ in z-space) run in float64 whatever the inputs' dtype,
and only their results are rounded to it, as the port's other
eigendecompositions (linalg.symsqrt, embeddings/nystrom.py). In f32, Λ⁻¹
of a positive basis's Γ^{1/2} (condition ~1e5 at 1024 functions) would
carry ~1e-2 relative error, and cuSOLVER's f32 eigh leaves its basis
orthonormal only to ~1e-4 at a few hundred.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stpy_tpu_torch.linalg import cho_solve, safe_cholesky


def _as(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def maximize_on_ellipsoid(x, Sigma, mu, c):
    """max xᵀθ over the ellipsoid (θ−μ)ᵀΣ(θ−μ) ≤ c², for x (m,) or a stack
    (A, m). Returns (value, θ*) with x's leading shape."""
    L = safe_cholesky(Sigma).L
    X = x.reshape(-1, x.shape[-1])
    Sinv_x = cho_solve(L, X.T).T
    denom = torch.sqrt(torch.clamp(torch.sum(X * Sinv_x, dim=-1), min=1e-30))
    theta = mu + (c / denom)[:, None] * Sinv_x
    theta = theta.reshape(x.shape)
    return torch.sum(x * theta, dim=-1), theta


def project_ellipsoid(p, eigvals, V, mu, c, iters: int = 40):
    """Exact Euclidean projection of each row of p onto
    {θ: (θ−μ)ᵀΣ(θ−μ) ≤ c²}, Σ = V diag(eigvals) Vᵀ: `iters` Newton steps on
    the secular equation Σ_i e_i z_i²/(1 + λe_i)² = c² in the eigenbasis,
    from λ = 1 (clipped at 0 after each step); rows inside stay."""
    z = (p - mu) @ V
    q = eigvals * z * z
    c2 = c * c
    inside = torch.sum(q, dim=-1) <= c2
    qe2 = 2.0 * q * eigvals
    one = torch.ones((), dtype=p.dtype, device=p.device)
    lam = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    for _ in range(iters):
        # f(λ) = Σ q r² − c², f'(λ) = −Σ 2qe r³ ≤ 0, r = 1/(1 + λe); the JAX
        # package's guard where(|f'| < 1e-30, −1e-30, f') is the clamp
        r = torch.reciprocal(torch.addcmul(one, lam[..., None], eigvals))
        r2 = r * r
        f = torch.linalg.vecdot(q, r2) - c2
        slope = torch.clamp(torch.linalg.vecdot(qe2, r2 * r), min=1e-30)
        lam = torch.clamp(torch.addcdiv(lam, f, slope), min=0.0)
    w = z / torch.addcmul(one, lam[..., None], eigvals)
    return torch.where(inside[..., None], p, mu + w @ V.T)


def _box(l, u, like):
    lo = _as(-math.inf if l is None else l, like)
    hi = _as(math.inf if u is None else u, like)
    return lo, hi


def _ascent_z(xz, eigvals, V, zmu, c, l, u, max_iter, dykstra_iters):
    """Projected ascent on xzᵀz over ellipsoid ∩ box in z-space, every row
    of xz at once; the best iterate of each row."""
    r0 = c / torch.sqrt(torch.clamp(torch.min(eigvals), min=1e-14))
    gnorm = torch.linalg.vector_norm(xz, dim=-1, keepdim=True) + 1e-30
    step = xz / gnorm

    def proj_C(z):
        p = torch.zeros_like(z)
        q = torch.zeros_like(z)
        for _ in range(dykstra_iters):
            zp = z + p
            a = project_ellipsoid(zp, eigvals, V, zmu, c)
            p = zp - a
            aq = a + q
            z = torch.clamp(aq, l, u)
            q = aq - z
        return z

    z = proj_C(torch.clamp(zmu, l, u).expand_as(xz))
    best_z, best_val = z, torch.sum(xz * z, dim=-1)
    for k in range(max_iter):
        z = proj_C(z + (r0 / math.sqrt(k + 1.0)) * step)
        v = torch.sum(xz * z, dim=-1)
        better = v > best_val
        best_z = torch.where(better[:, None], z, best_z)
        best_val = torch.where(better, v, best_val)
    return best_z


def _eigh64(A, like):
    """Eigenpairs of the symmetric part of A in float64, eigenvalues
    clipped at 1e-14, both rounded to `like`'s dtype."""
    eigvals, V = torch.linalg.eigh(0.5 * (A + A.T))
    return torch.clamp(eigvals, min=1e-14).to(like.dtype), V.to(like.dtype)


def _ascent_rect(X, Sigma, mu, c, l, u, Lambda, max_iter):
    """Non-square Λ: projected subgradient ascent on θ with an escalating
    box penalty, every row of X at once; the best feasible iterate of each
    row, μ where none was feasible."""
    eigvals, V = _eigh64(Sigma.double(), X)
    r0 = c / torch.sqrt(torch.clamp(torch.min(eigvals), min=1e-14))
    t = project_ellipsoid(mu.expand_as(X), eigvals, V, mu, c)
    best_t = t
    best_val = torch.full(X.shape[:-1], -math.inf, dtype=X.dtype,
                          device=X.device)
    for k in range(max_iter):
        zt = t @ Lambda.T
        over = torch.clamp(zt - u, min=0.0)
        under = torch.clamp(l - zt, min=0.0)
        g = X - (10.0 + k) * ((over - under) @ Lambda)
        gn = torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-30
        t = project_ellipsoid(t + (r0 / math.sqrt(k + 1.0)) * g / gn,
                              eigvals, V, mu, c)
        zt = t @ Lambda.T
        feas = torch.all((zt >= l - 1e-6) & (zt <= u + 1e-6), dim=-1)
        v = torch.where(feas, torch.sum(X * t, dim=-1),
                        torch.full_like(best_val, -math.inf))
        better = v > best_val
        best_t = torch.where(better[:, None], t, best_t)
        best_val = torch.where(better, v, best_val)
    return torch.where(torch.isfinite(best_val)[:, None], best_t,
                       mu.expand_as(best_t))


def maximize_on_elliptical_slice(
    x, Sigma, mu, c, l=None, Lambda=None, u=None,
    max_iter: int = 150, dykstra_iters: int = 25,
):
    """max xᵀθ s.t. (θ−μ)ᵀΣ(θ−μ) ≤ c², l ≤ Λθ ≤ u, for x (m,) or a stack
    (A, m) of functionals. The closed form where the box is slack at the
    ellipsoid's maximizer; elsewhere, for a square (invertible) Λ,
    projected ascent in z = Λθ, where the box is a clip, with Dykstra's
    projection onto ellipsoid ∩ box (150 steps of 25 rounds); for a
    non-square Λ, `_ascent_rect`. Returns (value, θ) with x's leading
    shape."""
    val, theta = maximize_on_ellipsoid(x, Sigma, mu, c)
    if Lambda is None:
        return val, theta
    X = x.reshape(-1, x.shape[-1])
    Th = theta.reshape(X.shape).clone()
    l, u = _box(l, u, X)
    z0 = Th @ Lambda.T
    feasible = torch.all((z0 >= l - 1e-9) & (z0 <= u + 1e-9), dim=-1)
    rows = torch.nonzero(~feasible).reshape(-1)
    if rows.numel():
        Xr = X[rows]
        if Lambda.shape[0] != Lambda.shape[1]:
            Th[rows] = _ascent_rect(Xr, Sigma, mu, c, l, u, Lambda, max_iter)
        else:
            Lam_inv64 = torch.linalg.inv(Lambda.double())
            eigvals, V = _eigh64(Lam_inv64.T @ Sigma.double() @ Lam_inv64, X)
            Lam_inv = Lam_inv64.to(X.dtype)
            best_z = _ascent_z(Xr @ Lam_inv, eigvals, V, Lambda @ mu, c, l, u,
                               max_iter, dykstra_iters)
            Th[rows] = best_z @ Lam_inv.T
    theta = Th.reshape(x.shape)
    return torch.sum(x * theta, dim=-1), theta


def KY_initialization(X):
    """Kumar-Yildirim initial core set for the minimum-volume ellipsoid:
    extreme points along successively deflated directions (host numpy)."""
    X = np.asarray(X)
    n, d = X.shape
    dirs = np.eye(d)
    picked, basis = [], []
    for i in range(d):
        v = dirs[i]
        for b in basis:
            v = v - (v @ b) * b
        if np.linalg.norm(v) < 1e-12:
            continue
        v = v / np.linalg.norm(v)
        proj = X @ v
        picked.extend([int(np.argmin(proj)), int(np.argmax(proj))])
        e = X[picked[-1]] - X[picked[-2]]
        if np.linalg.norm(e) > 1e-12:
            basis.append(e / np.linalg.norm(e))
    return sorted(set(picked))


def maximum_volume_ellipsoid(X, tol=1e-6, max_iter=2000):
    """Khachiyan's algorithm for the minimum-volume enclosing ellipsoid of
    the points X (n, d): (center c, shape A) with (x − c)ᵀA(x − c) ≤ 1 for
    every point. A design-time computation, on the host in numpy."""
    X = np.asarray(X, dtype=float)
    n, d = X.shape
    Q = np.vstack([X.T, np.ones(n)])
    w = np.ones(n) / n
    for _ in range(max_iter):
        Vm = Q @ np.diag(w) @ Q.T
        M = np.einsum("in,ij,jn->n", Q, np.linalg.inv(Vm), Q)
        j = int(np.argmax(M))
        step = (M[j] - d - 1.0) / ((d + 1) * (M[j] - 1.0))
        new_w = (1 - step) * w
        new_w[j] += step
        if np.linalg.norm(new_w - w) < tol:
            w = new_w
            break
        w = new_w
    c = X.T @ w
    cov = X.T @ np.diag(w) @ X - np.outer(c, c)
    return c, np.linalg.inv(cov) / d


def ellipsoid_cut(c, B, g):
    """Central ellipsoid cut: the smallest ellipsoid containing
    {x: gᵀ(x − c) ≤ 0} ∩ E(c, B)."""
    d = c.shape[0]
    Bg = B @ g
    b = Bg / torch.sqrt(torch.clamp(g @ Bg, min=1e-30))
    c_new = c - b / (d + 1.0)
    B_new = (d * d / (d * d - 1.0)) * (B - (2.0 / (d + 1.0)) * torch.outer(b, b))
    return c_new, B_new


def maximize_matrix_quadratic_on_ellipse(Z, Sigma, mu, c, iters=60):
    """max θᵀZθ s.t. (θ−μ)ᵀΣ(θ−μ) ≤ c², the trust-region subproblem:
    whitened by A = Σ^{-1/2}, the secular equation ‖(λI − B)⁻¹b‖ = c for
    λ > λ_max(B) by `iters` bisection steps in B's eigenbasis. Returns
    (value, θ*)."""
    eigS, VS = torch.linalg.eigh(Sigma)
    eigS = torch.clamp(eigS, min=1e-12)
    A = (VS / torch.sqrt(eigS)[None, :]) @ VS.T
    B = A @ Z @ A
    b = A @ (Z @ mu)
    d, V = torch.linalg.eigh(B)
    bt = V.T @ b
    lam_max = d[-1]

    def norm_w(lam):
        return torch.linalg.vector_norm(bt / (lam - d))

    eps = 1e-10 + 1e-8 * torch.abs(lam_max)
    lo = lam_max + eps
    hi = lam_max + torch.linalg.vector_norm(b) / max(float(c), 1e-12) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_big = norm_w(mid) > c
        lo, hi = torch.where(too_big, mid, lo), torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    w = V @ (bt / (lam - d))
    w = torch.where(torch.linalg.vector_norm(b) < 1e-14, c * V[:, -1], w)
    theta = mu + A @ w
    return theta @ (Z @ theta), theta


def minimize_matrix_quadratic_on_ellipse(Z, Sigma, mu, c, max_iter=200):
    """min θᵀZθ over the ellipsoid (Z ⪰ 0): 0 where 0 is feasible, else
    `max_iter` projected gradient steps of 1/‖Z‖_F from μ with the exact
    ellipsoid projection."""
    r0 = mu @ (Sigma @ mu)
    eigvals, V = torch.linalg.eigh(Sigma)
    eigvals = torch.clamp(eigvals, min=1e-12)
    step = 1.0 / (torch.linalg.matrix_norm(Z) + 1e-9)
    Zs = Z + Z.T            # ∇ θᵀZθ = (Z + Zᵀ)θ
    t = mu
    for _ in range(max_iter):
        t = project_ellipsoid(t - step * (Zs @ t), eigvals, V, mu, c)
    valc = t @ (Z @ t)
    inside = r0 <= c * c
    val = torch.where(inside, torch.zeros_like(valc), valc)
    theta = torch.where(inside, torch.zeros_like(mu), t)
    return val, theta


def maximize_quadratic_on_ellipse(x, Sigma, mu, c):
    """max (xᵀθ)² over the ellipsoid, attained at one of the two
    closed-form linear maximizers."""
    v_plus, t_plus = maximize_on_ellipsoid(x, Sigma, mu, c)
    v_minus, t_minus = maximize_on_ellipsoid(-x, Sigma, mu, c)
    take_plus = v_plus**2 >= v_minus**2
    val = torch.where(take_plus, v_plus**2, v_minus**2)
    return val, torch.where(take_plus, t_plus, t_minus)


def minimize_quadratic_on_ellipse(x, Sigma, mu, c):
    """min (xᵀθ)² over the ellipsoid: 0 where the hyperplane xᵀθ = 0 cuts
    it, else the square of the nearer side's value."""
    v_plus, _ = maximize_on_ellipsoid(x, Sigma, mu, c)
    v_minus, _ = maximize_on_ellipsoid(-x, Sigma, mu, c)
    lo, hi = -v_minus, v_plus
    crosses = (lo <= 0.0) & (hi >= 0.0)
    return torch.where(crosses, torch.zeros_like(lo),
                       torch.minimum(lo**2, hi**2))
