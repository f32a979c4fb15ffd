"""Large-n GP inference by preconditioned conjugate gradients, on one device.

Port of the single-device part of stpy_tpu/parallel/iterative.py: the CG
solvers, the low-rank preconditioners and `IterativeGP` with ``mesh=None``.
With ``lazy=True`` the Gram is never stored: every CG matvec is one
matrix-free Gram product per kernel atom (parallel/lazy_kernel.py, on the
card csrc/gram_matvec.cu and csrc/gram_matmat.cu), so memory stays O(n·r)
for the rank-r preconditioner basis and n goes past what a dense Cholesky
serves.

PyTorch runs eagerly, so each `jax.lax.while_loop` becomes a Python loop on
tensors that reads one scalar to the host per iteration (the loop test), and
`vmap` over Hutchinson probes becomes the probe block written out. The
iterates are the JAX package's: the same stagnation rule, halving
checkpoint, frozen columns, segment restarts and best-iterate return.

Not ported yet, each raising NotImplementedError naming its ROADMAP item:
the mesh tiers (``mesh`` other than None, Queue 1 item 11), the matrix-free
hyperparameter fit `optimize_params` (bbmm, Queue 1 items 5 and 11),
`sample_pathwise` (feature embeddings, Queue 1 item 8) and the double tier's
df-refined variance at ``var_refine >= 1`` (`_std_exact_df`, which needs
`compensated.df_gemm`, Queue 1 item 4).
"""

from __future__ import annotations

import warnings

import torch

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.kernels.df_plan import df_atom_desc, df_gram_from_desc
from stpy_tpu_torch.ops.gemv_df import gemv_df
from stpy_tpu_torch.parallel.lazy_kernel import (
    atom_params,
    fast_atoms,
    make_chunked_matmat,
    make_chunked_matvec,
    make_sum_matmat,
    make_sum_matvec,
)

# solves above this size run as segmented host loops (cg_solve_block_segmented)
SEGMENT_ABOVE = 32768


def _auto_window(stall_window, dtype):
    """`stall_window="auto"`: 100 iterations for f32 systems, off in f64."""
    if stall_window == "auto":
        stall_window = 100 if dtype == torch.float32 else None
    return (1 << 30) if stall_window is None else int(stall_window)


def _cg_columns(matmat, B, M_inv, tol, maxiter, stall_window):
    """`cg_solve` on every column of B at once, each column with its own
    state, as the JAX package's `vmap(cg_solve)`: a column stops on its own
    tolerance, maxiter or stagnation test and keeps its iterate from then
    on, while the block product still runs over all columns. Returns
    (X, per-column iterations, per-column R)."""
    win = _auto_window(stall_window, B.dtype)
    bnorm = torch.linalg.vector_norm(B, dim=0)
    X = torch.zeros_like(B)
    R = B
    P = M_inv(R)
    rz = torch.sum(R * P, dim=0)
    ckpt = torch.sum(R * R, dim=0)
    it = torch.zeros(B.shape[1], dtype=torch.int64, device=B.device)
    since = torch.zeros_like(it)
    stop = torch.zeros(B.shape[1], dtype=torch.bool, device=B.device)
    while True:
        go = ((torch.sqrt(torch.sum(R * R, dim=0)) > tol * bnorm)
              & (it < maxiter) & ~stop)
        if not bool(go.any()):      # the one host read of the iteration
            return X, it, R
        AP = matmat(P)
        alpha = rz / torch.sum(P * AP, dim=0)
        Xn = X + alpha * P
        Rn = R - alpha * AP
        Zn = M_inv(Rn)
        rz_new = torch.sum(Rn * Zn, dim=0)
        Pn = Zn + (rz_new / rz) * P
        rr = torch.sum(Rn * Rn, dim=0)
        at_ckpt = since + 1 >= win
        stop = torch.where(go, at_ckpt & (rr > 0.5 * ckpt), stop)
        ckpt = torch.where(go & at_ckpt, rr, ckpt)
        since = torch.where(go, torch.where(at_ckpt, 0, since + 1), since)
        X, R, P = (torch.where(go, new, old)
                   for new, old in ((Xn, X), (Rn, R), (Pn, P)))
        rz = torch.where(go, rz_new, rz)
        it = it + go.to(it.dtype)


def _identity(r):
    return r


def cg_solve(matvec, b, M_inv=None, tol=1e-8, maxiter=1000,
             stall_window="auto"):
    """Preconditioned conjugate gradients. Returns (x, iterations,
    residual_norm / ‖b‖).

    Stagnation stop: a tol below the f32 matvec noise floor (~√n·eps
    relative) makes the residual wander around its floor for ever. Every
    `stall_window` iterations the loop checks that ‖r‖² at least halved
    since the last checkpoint and exits otherwise; callers detect the case
    as (it < maxiter and residual > tol). "auto" = 100 for f32 systems, off
    in f64, where CG on ill-conditioned spectra can plateau legitimately
    (stpy_tpu/parallel/iterative.py:34-53). Pass an int to force a window,
    None to disable."""
    M_inv = _identity if M_inv is None else M_inv
    b = b.reshape(-1)
    bnorm = torch.linalg.vector_norm(b)
    X, it, R = _cg_columns(
        lambda P: matvec(P[:, 0])[:, None], b[:, None],
        lambda R: M_inv(R[:, 0]).reshape(-1, 1), tol, maxiter, stall_window)
    return X[:, 0], int(it[0]), torch.linalg.vector_norm(R[:, 0]) / bnorm


def cg_solve_block(matmat, B, M_inv=None, tol=1e-8, maxiter=1000,
                   stall_window="auto"):
    """CG on r right-hand sides at once: per-column inner products, one
    block product per iteration. Converged columns freeze (zero step) while
    the rest continue; an optional `M_inv` applied to the (n, r) residual
    block makes it block PCG. The stagnation stop reads the worst active
    column's relative ‖r‖² (see `cg_solve`). Returns (X, iterations)."""
    win = _auto_window(stall_window, B.dtype)
    precond = M_inv is not None
    bnorm = torch.linalg.vector_norm(B, dim=0)
    bnorm2 = torch.clamp(bnorm * bnorm, min=1e-30)
    X = torch.zeros_like(B)
    R = B
    P = M_inv(B) if precond else B
    rz = torch.sum(B * P, dim=0)
    rr = torch.sum(B * B, dim=0)
    ckpt = torch.max(rr / bnorm2)
    since, it = 0, 0
    stop = torch.zeros((), dtype=torch.bool, device=B.device)
    while it < maxiter:
        active = torch.sqrt(rr) > tol * bnorm
        if not bool(active.any() & ~stop):   # the one host read
            break
        AP = matmat(P)
        denom = torch.sum(P * AP, dim=0)
        alpha = torch.where(
            active, rz / torch.where(denom == 0, 1.0, denom), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = M_inv(R) if precond else R
        rz_new = torch.sum(R * Z, dim=0)
        rr = torch.sum(R * R, dim=0)
        beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        P = Z + beta * P
        rz = rz_new
        worst = torch.max(torch.where(active, rr / bnorm2, 0.0))
        if since + 1 >= win:
            stop = worst > 0.5 * ckpt
            ckpt, since = worst, 0
        else:
            since += 1
        it += 1
    return X, it


def cg_solve_block_segmented(matmat, B, M_inv=None, tol=1e-8,
                             maxiter=1000, segment=100):
    """Block CG as a host loop of `segment`-iteration solves, each restarted
    from the current iterate's true residual; stops when a segment fails to
    halve the worst column's relative residual and returns the best iterate
    seen. Returns (X, total iterations).

    The JAX package bounds its device programs this way because a
    multi-minute `while_loop` killed the TPU worker
    (stpy_tpu/parallel/iterative.py:151-168). The port keeps it because the
    restarts change the iterates, and the port is held to the reference's
    results (ROADMAP Queue 1 item 11 asks whether to drop it)."""
    bnorm_safe = torch.clamp(torch.linalg.vector_norm(B, dim=0), min=1e-30)
    X = torch.zeros_like(B)
    total = 0
    best = (float("inf"), X)
    prev_worst = float("inf")
    while total < maxiter:
        R = B - matmat(X) if total else B
        worst = float(torch.max(torch.linalg.vector_norm(R, dim=0)
                                / bnorm_safe))
        if worst < best[0]:
            best = (worst, X)
        if worst <= tol:
            break
        if worst > 0.5 * prev_worst:
            # segment-level stagnation: at the f32 floor a restart solves
            # noise and pushes X away from the best iterate
            break
        prev_worst = worst
        dX, it = cg_solve_block(
            matmat, R, M_inv=M_inv, tol=tol,
            maxiter=min(segment, maxiter - total),
            # the auto window (100) never fires inside a segment-length
            # solve; half a segment keeps in-segment floor detection alive
            stall_window=max(25, segment // 2),
        )
        X = X + dX
        total += int(it)
        if int(it) == 0:
            break
    return best[1] if best[0] < float("inf") else X, total


def cg_solve_segmented(matvec, b, M_inv=None, tol=1e-8, maxiter=1000,
                       segment=100):
    """Single-RHS adapter over `cg_solve_block_segmented`. Returns
    (x, iterations, residual_norm) like `cg_solve`; the residual is
    recomputed with one extra matvec."""
    b = b.reshape(-1)
    X, it = cg_solve_block_segmented(
        lambda V: matvec(V[:, 0])[:, None], b[:, None],
        M_inv=None if M_inv is None else (lambda R: M_inv(R[:, 0])[:, None]),
        tol=tol, maxiter=maxiter, segment=segment,
    )
    x = X[:, 0]
    res = torch.linalg.vector_norm(b - matvec(x)) / torch.clamp(
        torch.linalg.vector_norm(b), min=1e-30)
    return x, it, res


def resolve_precond_rank(rank, n: int) -> int:
    """Resolve a `precond_rank` setting ("auto" or int) for an n-point fit:
    "auto" is unpreconditioned up to n = 16384 and rank 512 above — the
    JAX package's measured rank-vs-iterations knee
    (stpy_tpu/parallel/iterative.py:223-237)."""
    if rank != "auto":
        return int(rank)
    return 0 if n <= 16384 else 512


def pivoted_cholesky_kernel(kernel_object, x, rank, params_dict=None):
    """Partial pivoted Cholesky of the kernel Gram from `rank` kernel column
    evaluations: Lm (rank, n) with K ≈ LmᵀLm, O(n·rank) memory. Each step
    picks the largest residual diagonal, as the JAX package's fori loop."""
    pd = params_dict or kernel_object.params_dict
    n = x.shape[0]
    rank = int(min(rank, n))
    d = kernel_object.diag(x, pd).reshape(-1).clone()
    Lm = torch.zeros((rank, n), dtype=x.dtype, device=x.device)
    for i in range(rank):
        p = int(torch.argmax(d))
        col = kernel_object.eval_params(pd, x, x[p:p + 1]).reshape(-1)
        col = col - Lm[:, p] @ Lm            # rows >= i are still zero
        l = col / torch.sqrt(torch.clamp(d[p], min=1e-30))
        Lm[i] = l
        d = torch.clamp(d - l * l, min=0.0)
        d[p] = 0.0                           # never re-pick a pivot
    return Lm


def _eigh64(A):
    """eigh of a small symmetric matrix computed in float64 and returned in
    A's dtype. The eigenform apply below stays SPD only while U = Q·V is
    orthonormal to well under its 256·eps deflation margin; with cuSOLVER's
    f32 eigh, U was orthonormal only to 2.65e-4 at r = 512 (H100, n = 32768),
    which made the apply indefinite (uᵀM⁻¹u down to −3.8e-3) and PCG
    diverge. In float64 V is orthonormal to ~1e-15 and rounds to f32 at
    ~eps. The JAX
    package's f32 eigh needs no such step (stpy_tpu/parallel/iterative.py:
    287-300); on f64 inputs this is the plain eigh."""
    lam, V = torch.linalg.eigh(A.to(torch.float64))
    return lam.to(A.dtype), V.to(A.dtype)


def _eigenform_apply(U, lam, noise):
    """SPD apply M⁻¹v = (v − U diag(λ/(λ+σ²)) Uᵀv)/σ² for an (almost)
    orthonormal U and eigenvalue estimates lam.

    SPD deflation cap: once σ²/λ drops below U's f32 orthonormality error,
    the exact coefficient makes I − U·coef·Uᵀ indefinite and CG breaks
    outright, so the deflation is capped at 1 − 256·eps (the JAX package's
    measured safety constant, stpy_tpu/parallel/iterative.py:307-316)."""
    lam = torch.clamp(lam, min=0.0)
    s2 = noise * noise
    cmax = 1.0 - 256.0 * torch.finfo(U.dtype).eps
    coef = torch.clamp(lam / (lam + s2), max=cmax)

    def M_inv(rhs):
        rhs2 = rhs if rhs.dim() == 2 else rhs[:, None]
        t = U.T @ rhs2
        out = ((rhs2 - U @ (coef[:, None] * t)) / s2).to(rhs.dtype)
        return out if rhs.dim() == 2 else out.reshape(rhs.shape)

    return M_inv


def lowrank_eigen_precond(B, noise):
    """SPD eigenform apply of (BBᵀ + σ²I)⁻¹ for a low-rank factor B (n, r),
    QR first: Householder QR of B is backward stable at any conditioning,
    so U = Q·V (V the eigenvectors of the small RRᵀ) stays orthonormal to
    ~eps where an eigh-and-lift of BᵀB would not
    (stpy_tpu/parallel/iterative.py:276-300)."""
    Qn, R = torch.linalg.qr(B)
    lam, V = _eigh64(R @ R.T)
    return _eigenform_apply(Qn @ V, lam, noise)


def make_pivchol_precond(Lm, noise):
    """Preconditioner companion of `pivoted_cholesky_kernel`: the eigenform
    apply of (LmᵀLm + σ²I)⁻¹; takes (n,) vectors or (n, r) blocks."""
    return lowrank_eigen_precond(Lm.T, noise)


def _blocked_k_apply(matmat, noise, block):
    """K·V from the lazy-path convention matmat ((K + σ²I)·V): σ² is
    subtracted, and wide V goes through in `block`-column slabs."""
    s2 = noise * noise

    def k_apply(V):
        outs = []
        for c0 in range(0, V.shape[1], block):
            blk = V[:, c0:c0 + block]
            outs.append(matmat(blk) - s2 * blk)
        return torch.cat(outs, dim=1)

    return k_apply


def _rayleigh_compress_precond(Y, k_apply, noise):
    """SPD apply of (K_r + σ²I)⁻¹ from the Rayleigh compression of K onto a
    sketch Y: Q = qr(Y), T = QᵀKQ, U = Q·V — no inverse anywhere, so no
    junk eigenvalue estimates. Two f32 safeguards keep it SPD on hardware
    (stpy_tpu/parallel/iterative.py:373-382): a second QR pass (one
    Householder pass leaves QᵀQ − I ~ 1.4e-5 at n = 65k in f32) and the
    deflation cap of `_eigenform_apply`; the small eigh runs in float64
    (`_eigh64`)."""
    Q, _ = torch.linalg.qr(Y)
    Q, _ = torch.linalg.qr(Q)
    T = Q.T @ k_apply(Q)
    lam, V = _eigh64(0.5 * (T + T.T))
    return _eigenform_apply(Q @ V, lam, noise)


def rayleigh_nystrom_precond(C, matmat, noise, *, block=128):
    """Landmark-sketch Rayleigh EVD preconditioner, the large-n default: the
    range basis from the landmark cross Gram C = K[:, idx], eigenvalues from
    the Rayleigh compression QᵀKQ. Construction: one (n, r) QR (two passes),
    one K·(n, r) sweep of `block`-column matmats, one (r, r) eigh. `matmat`
    computes (K + σ²I)·V; σ² is subtracted internally."""
    return _rayleigh_compress_precond(
        C, _blocked_k_apply(matmat, noise, block), noise)


def nystrom_precond_from_cross(C, idx, noise, shift=1e-5):
    """Randomized-Nyström preconditioner from a landmark cross Gram
    C = K[:, idx] (n, r): (C K[idx, idx]⁺ Cᵀ + σ²I)⁻¹, the pseudo-inverse's
    eigenvalues clamped at `shift`·λmax (stpy_tpu/parallel/iterative.py:
    435-456), then the shared eigenform apply."""
    Wm = C[idx]
    lw, Qw = _eigh64(Wm)
    lw = torch.clamp(lw, min=shift * torch.clamp(lw[-1], min=1e-30))
    B = C @ (Qw * torch.rsqrt(lw)[None, :])
    return lowrank_eigen_precond(B, noise)


class IterativeGP:
    """Exact-GP inference by preconditioned CG (API of GaussianProcess:
    fit_gp / mean / mean_std), for n where a dense Cholesky no longer fits.

    ``lazy=True`` never stores the Gram; ``lazy=False`` builds the dense
    (n, n) Gram once and runs the same solvers on it. `generator` (a CPU
    `torch.Generator`) draws the landmark indices of the preconditioner and
    the Hutchinson probes; by default each fit draws from a fresh generator
    seeded with 0, so refits are repeatable. The model lives on the
    kernel's device (the card unless the kernel was built elsewhere)."""

    def __init__(self, kernel_object, s=0.1, mesh=None, axis="tp",
                 tol=1e-6, maxiter=500, lazy=False,
                 chunk=2048, precond_rank="auto", precision="single",
                 df_refine_steps=2, df_chunk=4096, var_refine=1,
                 device=None, dtype=None, generator=None):
        if mesh is not None:
            raise NotImplementedError(
                "IterativeGP over a device mesh needs torch.distributed, "
                "ROADMAP Queue 1 item 11")
        if precision not in ("single", "double"):
            raise ValueError(
                f"precision must be single|double, got {precision}")
        if device is not None and torch.device(device) != kernel_object.device:
            raise ValueError(f"device={device} disagrees with the kernel's "
                             f"{kernel_object.device}")
        if dtype is not None and dtype != kernel_object.dtype:
            raise ValueError(f"dtype={dtype} disagrees with the kernel's "
                             f"{kernel_object.dtype}")
        self.kernel_object = kernel_object
        self.device = kernel_object.device
        self.dtype = kernel_object.dtype
        self.s = s
        self.mesh = mesh
        self.axis = axis
        self.tol = tol
        self.maxiter = maxiter
        self.lazy = lazy
        self.chunk = chunk   # row chunk of the general (any-kernel) matvec
        # "auto" resolves per fit size (resolve_precond_rank); an int
        # overrides, 0 disables
        self.precond_rank = precond_rank
        self.precision = precision
        self.df_refine_steps = max(0, int(df_refine_steps))
        self.df_chunk = int(df_chunk)
        self.var_refine = max(0, int(var_refine))
        self.generator = generator
        self._df_desc_cache = None
        self._A_df = None
        self.x = self.y = self.A = None
        self.fit_status = None
        self.fitted = False

    def _tensor(self, v):
        return as_tensor(v, device=self.device, dtype=self.dtype)

    def _generator(self):
        if self.generator is not None:
            return self.generator
        return torch.Generator().manual_seed(0)

    # -- operators -------------------------------------------------------
    def _lazy_matvec_or_none(self, x):
        """Matrix-free (K + σ²I)·v: one matrix-free Gram pass per atom for
        sums of fused atoms, else the row-chunked general matvec."""
        ko = self.kernel_object
        atoms = fast_atoms(ko)
        if atoms is None:
            return make_chunked_matvec(ko, x, noise=self.s, chunk=self.chunk)
        gk = [atom_params(ko, a) for a in atoms]
        return make_sum_matvec(x, atoms, [g for g, _ in gk],
                               [k for _, k in gk], noise=self.s)

    def _lazy_matmat(self, x):
        """Block-RHS companion of the lazy matvec (same kernel config)."""
        ko = self.kernel_object
        atoms = fast_atoms(ko)
        if atoms is None:
            return make_chunked_matmat(ko, x, noise=self.s, chunk=self.chunk)
        gk = [atom_params(ko, a) for a in atoms]
        return make_sum_matmat(x, atoms, [g for g, _ in gk],
                               [k for _, k in gk], noise=self.s)

    def _matvec_factory(self, x):
        """(matvec, M_inv) of (K + σ²I), and the block companion
        `self._matmat` that `mean_std`'s exact variance runs on."""
        ko = self.kernel_object
        n = x.shape[0]
        if self.lazy:
            self._matmat = self._lazy_matmat(x)
            M_inv = None
            rank = resolve_precond_rank(self.precond_rank, n)
            if rank > 0:
                # landmark-sketch Rayleigh EVD (see rayleigh_nystrom_precond)
                r = int(min(rank, n))
                idx = torch.randperm(n, generator=self._generator())[:r]
                C = ko.eval_params(ko.params_dict, x, x[idx.to(x.device)])
                M_inv = rayleigh_nystrom_precond(C, self._matmat, self.s)
            return self._lazy_matvec_or_none(x), M_inv
        K = ko.gram(x)
        K.diagonal().add_(self.s ** 2)
        self._matmat = lambda V: K @ V
        return (lambda v: K @ v), None

    # -- double-float tier -------------------------------------------------
    def _df_desc(self):
        if self._df_desc_cache is None:
            self._df_desc_cache = df_atom_desc(self.kernel_object)
        return self._df_desc_cache

    def _df_cross_gemv(self, a, b, vh, vl, desc):
        """Exact df K(a, b)·(vh + vl), row-chunked: per chunk one (hi, lo)
        Gram (csrc/gram_df.cu) and one exact df GEMV (csrc/gemv_df.cu); the
        (df_chunk, n) pair is a transient. Returns (hi, lo) of shape
        (len(a),)."""
        ko = self.kernel_object
        outs_h, outs_l = [], []
        for r0 in range(0, a.shape[0], self.df_chunk):
            Kh, Kl = df_gram_from_desc(ko, {}, a[r0:r0 + self.df_chunk], b,
                                       desc)
            # the pair is f32; a float64 model (CPU tests) holds the same
            # values
            Ph, Pl = gemv_df(Kh.to(self.dtype), Kl.to(self.dtype), vh, vl=vl)
            outs_h.append(Ph)
            outs_l.append(Pl)
        return torch.cat(outs_h), torch.cat(outs_l)

    # -- fitting -------------------------------------------------------------
    def fit_gp(self, x, y):
        x = self._tensor(x)
        y = self._tensor(y).reshape(-1, 1)
        self.x, self.y = x, y
        self.n = x.shape[0]
        self._A_df = None
        self.fitted = False
        matvec, M_inv = self._matvec_factory(x)
        self._matvec = matvec
        self._M_inv = M_inv

        solve = cg_solve_segmented if self.n > SEGMENT_ABOVE else cg_solve
        alpha, it, res = solve(matvec, y.reshape(-1), M_inv=M_inv,
                               tol=self.tol, maxiter=self.maxiter)
        self.A = alpha.reshape(-1, 1)
        self.cg_iterations = int(it)
        self.cg_residual = float(res)
        converged = self.cg_residual <= self.tol
        stalled = (not converged) and self.cg_iterations < self.maxiter
        self.cg_stalled = stalled
        if not converged and self.precision != "double":
            # in double mode the df refinement absorbs a loose inner solve,
            # so only the f32 tier warns here
            if stalled:
                warnings.warn(
                    f"IterativeGP CG stagnated at relative residual "
                    f"{self.cg_residual:.1e} after {self.cg_iterations} "
                    f"iterations (tol {self.tol:.1e} is below the f32 "
                    "matvec noise floor, ~sqrt(n)*eps relative); the "
                    "posterior is as accurate as one f32 pass allows — "
                    "use precision='double' for tighter solves",
                    stacklevel=2,
                )
            else:
                warnings.warn(
                    f"IterativeGP CG hit maxiter={self.maxiter} at "
                    f"relative residual {self.cg_residual:.1e} (tol "
                    f"{self.tol:.1e}); posterior accuracy is bounded by "
                    "this residual — raise maxiter/precond_rank or use "
                    "precision='double'",
                    stacklevel=2,
                )
        self.df_residuals = None
        if self.precision == "double":
            stalled = self._refine_double(x, y, matvec, M_inv, converged)
        self.fit_status = {
            "converged": bool(converged),
            "stalled_at_floor": bool(stalled),
            "cg_iterations": self.cg_iterations,
            "cg_residual": self.cg_residual,
            "n": int(self.n),
            "precision": self.precision,
            "df_residuals": (list(self.df_residuals)
                             if self.precision == "double" else None),
        }
        self.fitted = True
        return None

    def _refine_double(self, x, y, matvec, M_inv, converged):
        """Iterative refinement of alpha with exact df residuals
        y − (K + s²I)·α, alpha carried as a df pair: contracts at the inner
        CG's relative error per step. The O(n) terms run in float64 around
        the df GEMV kernel, where the JAX package needs TwoSum/TwoProd.
        Returns whether the refinement failed to contract."""
        f64 = torch.float64
        desc = self._df_desc()
        s2 = self.s * self.s
        y64 = y.to(f64)
        yn = float(torch.linalg.vector_norm(y))
        a_h = self.A
        a_l = torch.zeros_like(a_h)
        # exact relative residual before each correction: ‖α − α*‖ ≤ ‖r‖/σ²
        self.df_residuals = []
        for _ in range(self.df_refine_steps):
            Ph, Pl = self._df_cross_gemv(x, x, a_h, a_l, desc)
            alpha = a_h.to(f64) + a_l.to(f64)
            r = y64 - (Ph.to(f64) + Pl.to(f64))[:, None] - s2 * alpha
            self.df_residuals.append(
                float(torch.linalg.vector_norm(r)) / yn)
            d, _, _ = cg_solve(matvec, r.reshape(-1).to(self.dtype),
                               M_inv=M_inv, tol=self.tol,
                               maxiter=self.maxiter)
            alpha += d.reshape(-1, 1).to(f64)
            a_h = alpha.to(self.dtype)
            a_l = (alpha - a_h.to(f64)).to(self.dtype)
        self._A_df = torch.cat([a_h, a_l], dim=1)
        self.A = self._A_df[:, :1]
        rs = self.df_residuals
        stalled = ((len(rs) >= 2 and rs[0] > 0 and rs[-1] > 0.5 * rs[0])
                   or (len(rs) >= 1 and rs[-1] > 1e-1))
        if stalled or (not converged and self.df_refine_steps == 0):
            warnings.warn(
                "IterativeGP double-mode refinement is not contracting "
                f"(df residuals {rs}, inner CG residual "
                f"{self.cg_residual:.1e}); the posterior is bounded by "
                "the LAST df residual, not the df floor — raise "
                "maxiter/precond_rank so the inner solve makes progress",
                stacklevel=3,
            )
        return stalled

    # -- prediction ------------------------------------------------------------
    def mean(self, xtest):
        xtest = self._tensor(xtest)
        if self._A_df is not None:
            # exact df cross-GEMV on the df alpha pair: an f32 mean GEMV
            # would cap the mean at eps·‖K*‖‖α‖/‖μ‖
            Mh, Ml = self._df_cross_gemv(xtest, self.x, self._A_df[:, :1],
                                         self._A_df[:, 1:], self._df_desc())
            return (Mh + Ml)[:, None]
        return self.kernel_object.cross(xtest, self.x) @ self.A

    def mean_std(self, xtest, probes=16, generator=None, method=None,
                 exact_threshold=1024):
        """Mean exactly; variance exactly (block CG, 128 test points per
        block — the default up to `exact_threshold` points) or by
        `probes` Hutchinson probes (unbiased but noisy; for very large test
        sets), the Rademacher probes drawn from `generator` (default: the
        model's, else a fresh one seeded with 0)."""
        xtest = self._tensor(xtest)
        t = xtest.shape[0]
        method = method or ("exact" if t <= exact_threshold else "hutchinson")
        if (method == "exact" and self.precision == "double"
                and self.var_refine > 0):
            raise NotImplementedError(
                "the df-refined matrix-free variance (precision='double', "
                "var_refine >= 1) needs compensated.df_gemm, ROADMAP Queue 1 "
                "item 4; pass var_refine=0 for the f32 block-CG variance")
        mu = self.mean(xtest)
        M_inv = self._M_inv
        K_star = self.kernel_object.cross(xtest, self.x)       # (t, n)
        kss = self.kernel_object.diag(xtest)
        if method == "exact":
            solver = (cg_solve_block_segmented if self.n > SEGMENT_ABOVE
                      else cg_solve_block)
            B = K_star.T                                       # (n, t)
            quads = []
            for c0 in range(0, t, 128):
                blk = B[:, c0:c0 + 128]
                sol, _ = solver(self._matmat, blk, M_inv=M_inv, tol=self.tol,
                                maxiter=self.maxiter)
                quads.append(torch.sum(blk * sol, dim=0))
            var = torch.clamp(kss - torch.cat(quads), min=1e-12)
            return mu, torch.sqrt(var)[:, None]

        g = generator if generator is not None else self._generator()
        Z = (2 * torch.randint(0, 2, (t, probes), generator=g) - 1).to(
            device=self.device, dtype=self.dtype)
        # the JAX package vmaps cg_solve over the probes; _cg_columns is
        # that vmap written out, one block product per iteration
        sol, _, _ = _cg_columns(
            self._matmat, K_star.T @ Z,
            _identity if M_inv is None else M_inv,
            self.tol, self.maxiter, "auto")
        est = torch.mean(Z * (K_star @ sol), dim=1)
        var = torch.clamp(kss - est, min=1e-12)
        return mu, torch.sqrt(var)[:, None]

    # -- not ported yet ------------------------------------------------------
    def optimize_params(self, *args, **kwargs):
        raise NotImplementedError(
            "the matrix-free evidence fit (parallel/bbmm.py) is ROADMAP "
            "Queue 1 items 5 and 11")

    def sample_pathwise(self, *args, **kwargs):
        raise NotImplementedError(
            "pathwise sampling needs the feature embeddings, ROADMAP Queue 1 "
            "item 8")
