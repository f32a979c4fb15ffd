"""Dense linear algebra for GP fits: jittered Cholesky and triangular solves.

Port of the part of stpy_tpu/linalg.py on the exact-GP path, with the same
names and semantics. The JAX bodies are XLA ops, not Pallas kernels, so the
port calls cuSOLVER / cuBLAS through `torch.linalg.cholesky_ex` and
`torch.linalg.solve_triangular`. The exception is `chol_dense(K, fast=True)`
(and `safe_cholesky(K, fast=True)` on it): for a float32 K on the card with
n ≥ 4096 it runs the blocked factorization `ops.syrk.chol_blocked_syrk` on
the hand kernels csrc/chol_leaf.cu and csrc/syrk_lower.cu, where the JAX
package runs its Pallas kernels on the TPU. Failure is reported as a
returned flag, never raised.

The `precision`, `precision_bwd`, `nb` and `leaf_inv` arguments exist for
signature parity and have no effect: they pick the TPU's bf16-pass count and
blocking, while the card computes in IEEE f32 / f64 (TF32 is off, see
config.py). The exceptions are the functions whose blocking is their
point: `chol_recursive` factors by divide and conquer on `nb`-sized leaves,
`diag_block_invs` inverts the `nb`-sized diagonal blocks, and
`tri_solve_chunked` solves `chunk` columns at a time (on the TPU to bound
its memory; here one trsm already holds nothing beyond its output).
`safe_cholesky_rebuild` runs the jitter ladder on a matrix rebuilt for
each attempt.
The rank-1 updates (`chol_rank1_update`, `woodbury_inv_update`,
`schur_complement_extend`) are O(n²); `symsqrt` and `power_iteration`
serve the embeddings and the samplers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stpy_tpu_torch.config import default_jitter
from stpy_tpu_torch.ops.syrk import chol_blocked_syrk

# the JAX package takes the fast factorization from this n up
# (stpy_tpu/linalg.py:61)
FAST_MIN_N = 4096


class CholResult(NamedTuple):
    L: torch.Tensor          # lower-triangular factor of K + jitter*I
    jitter: torch.Tensor     # jitter actually used (scalar)
    ok: torch.Tensor         # bool: factorization succeeded


def _mean_diag_scale(K):
    scale = torch.mean(torch.diagonal(K))
    return torch.where(scale <= 0, torch.ones_like(scale), scale)


def _cholesky(A):
    """Lower factor of A, NaN-filled where the factorization fails (the
    JAX convention the jitter ladder and `ok` flags rely on)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def chol_jittered(K, jitter: float | None = None):
    """Single fixed-jitter Cholesky of K + jitter·mean(diag K)·I;
    differentiable. `safe_cholesky` is the escalating inference-time one."""
    base = default_jitter(K.dtype) if jitter is None else jitter
    A = K + base * _mean_diag_scale(K) * torch.eye(
        K.shape[0], dtype=K.dtype, device=K.device)
    return _cholesky(A)


def chol_dense(K, fast: bool = False):
    """Single-device dense lower Cholesky, NaN-filled where it fails.

    Default: cuSOLVER / LAPACK (`torch.linalg.cholesky_ex`). `fast=True`
    takes the blocked factorization on the hand kernels
    (`ops.syrk.chol_blocked_syrk`) exactly where the JAX package takes its
    Pallas one: n ≥ 4096 and K on the accelerator (here `K.is_cuda`). It is
    for MAP-style fits and preconditioners; the JAX package keeps its
    default factor on the accuracy-gated posterior path. On the card the
    fast factorization is float32 only, so `fast=True` with another dtype
    on the card raises instead of turning quietly into cuSOLVER; on the CPU
    `fast` changes nothing, as the JAX package's non-TPU branch."""
    if fast and K.is_cuda:
        if K.dtype != torch.float32:
            raise TypeError(
                "chol_dense(fast=True): the fast factorization on the card is "
                f"float32 (its hand kernels compute in f32), got {K.dtype}")
        if K.shape[0] >= FAST_MIN_N:
            return chol_blocked_syrk(K)
    return _cholesky(K)


def safe_cholesky(K, jitter: float | None = None, max_tries: int = 6,
                  fast: bool = False) -> CholResult:
    """Cholesky of a PSD matrix with an escalating (10x) jitter ladder:
    jitter·scale, then ×10 up to `max_tries` more times, scale being the
    mean diagonal. Never raises; `ok` reports success.

    The jitter goes onto K's diagonal in place and K's original diagonal
    is restored before returning, so no n² copy of K is made (1 GiB at
    n = 16k in f32). With `fast=True` each attempt is `chol_dense(K,
    fast=True)` and succeeds when its factor is all finite, as in the JAX
    package; with `fast=False` each attempt is one `cholesky_ex`, judged by
    its info code."""
    base = default_jitter(K.dtype) if jitter is None else jitter
    scale = _mean_diag_scale(K)
    diag = torch.diagonal(K)
    orig = diag.clone()
    j = torch.tensor(base, dtype=K.dtype, device=K.device)
    try:
        for t in range(max_tries + 1):
            if t:
                j = j * 10.0
            diag.copy_(orig + j * scale)
            L = None   # the failed attempt's factor goes before the next
            if fast:
                L = chol_dense(K, fast=True)
                ok = bool(torch.isfinite(L).all())
            else:
                L, info = torch.linalg.cholesky_ex(K)
                ok = int(info) == 0
            if ok:
                return CholResult(L=L, jitter=j * scale,
                                  ok=torch.tensor(True, device=K.device))
        return CholResult(L=torch.full_like(L, float("nan")),
                          jitter=j * scale,
                          ok=torch.tensor(False, device=K.device))
    finally:
        diag.copy_(orig)


def safe_cholesky_rebuild(build_k, scale, jitter: float | None = None,
                          max_tries: int = 6, fast: bool = False,
                          dtype=None) -> CholResult:
    """Jitter-ladder Cholesky that rebuilds the jittered matrix for each
    attempt instead of keeping the pre-jitter Gram for the whole ladder
    (recompute over residency, stpy_tpu/linalg.py:99-150).

    `build_k(j)` returns a fresh K + j·I for an absolute jitter j (from the
    kernel's inputs, not by indexing a kept K); `scale` is K's mean
    diagonal (O(n) from `kernel.diag`). The ladder is `safe_cholesky`'s:
    j = base·scale·10^t for t = 0 … max_tries, base = `jitter` or
    `default_jitter(dtype)` (dtype: `dtype`, else the scale's, float64 for
    a number). An attempt holds its fresh matrix and its factor (one
    `cholesky_ex`, judged by its info code, as `safe_cholesky`'s), and the
    matrix goes before the next build, so K is never held beside the
    ladder; a retry costs one more build. With `fast=True` each attempt is
    `chol_dense(A, fast=True)`. Never raises; `ok` reports success.

    The factor is `cholesky_ex`'s own column-major output, as
    `safe_cholesky`'s: written over the row-major matrix instead, the
    double tier's f32 variance at n = 32768 lay 17× further from float64
    (PERF.md, PR 18)."""
    scale = torch.as_tensor(scale)
    dt = dtype if dtype is not None else (
        scale.dtype if scale.is_floating_point() else torch.float64)
    base = default_jitter(dt) if jitter is None else jitter
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale).to(dt)
    j = torch.tensor(base, dtype=dt, device=scale.device)
    L = None
    for t in range(max_tries + 1):
        if t:
            j = j * 10.0
        L = None   # the failed attempt's buffer goes before the next build
        A = build_k(j * scale)
        if fast:
            L = chol_dense(A, fast=True)
            ok = bool(torch.isfinite(L).all())
        else:
            L, info = torch.linalg.cholesky_ex(A)
            ok = int(info) == 0
        del A
        if ok:
            return CholResult(L=L, jitter=j * scale,
                              ok=torch.tensor(True, device=L.device))
    return CholResult(L=L.fill_(float("nan")), jitter=j * scale,
                      ok=torch.tensor(False, device=L.device))


def cho_solve(L, b):
    """Solve (L Lᵀ) x = b given the lower Cholesky factor L."""
    return torch.cholesky_solve(b, L, upper=False)


def tri_solve(L, b, lower: bool = True):
    return torch.linalg.solve_triangular(L, b, upper=not lower)


def tri_solve_blocked(L, B, nb: int = 512, precision=None, leaf_inv=None):
    """Lower-triangular solve L X = B for a wide right-hand side (one
    cuBLAS trsm on the card). `nb`, `precision` and `leaf_inv` have no
    effect (see the module docstring)."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def cho_solve_blocked(L, b, nb: int = 512, precision=None, leaf_inv=None,
                      precision_bwd=None):
    """(L Lᵀ)⁻¹ b. `nb`, `precision`, `leaf_inv` and `precision_bwd` have no
    effect (see the module docstring)."""
    return torch.cholesky_solve(b, L, upper=False)


def tri_solve_blocked_t(L, B, nb: int = 512, precision=None, leaf_inv=None):
    """Solve Lᵀ X = B (backward substitution) for lower L: the second half
    of `cho_solve_blocked`, one cuBLAS trsm on the card. `nb`, `precision`
    and `leaf_inv` have no effect (see the module docstring)."""
    return torch.linalg.solve_triangular(L.T, B, upper=True)


def diag_block_invs(L, nb: int):
    """Inverses of the (nb, nb) diagonal blocks of lower-triangular L (n a
    multiple of nb) as one (n/nb, nb, nb) tensor: a single batched
    triangular solve."""
    k = L.shape[0] // nb
    blocks = torch.diagonal(L.reshape(k, nb, k, nb), dim1=0, dim2=2)
    blocks = blocks.permute(2, 0, 1)
    eye = torch.eye(nb, dtype=L.dtype, device=L.device).expand(k, nb, nb)
    return torch.linalg.solve_triangular(blocks, eye, upper=False)


def _pad_identity(K, pad):
    """K in the top-left corner of an (n + pad)² matrix whose other
    diagonal entries are 1 and other entries 0."""
    n = K.shape[0]
    Kp = torch.zeros((n + pad, n + pad), dtype=K.dtype, device=K.device)
    Kp[:n, :n] = K
    Kp.diagonal()[n:] = 1.0
    return Kp


def _chol_rec(A, nb, out):
    """Writes the lower factor of A into `out` (zero above the diagonal):
    L11 = chol(A11), L21ᵀ = L11⁻¹ A12, L22 = chol(A22 − L21 L21ᵀ), the
    Schur complement formed in float64 and rounded once to A's dtype."""
    n = A.shape[0]
    k = n // nb
    if k <= 1:
        out.copy_(_cholesky(A))
        return
    h = (k // 2) * nb
    _chol_rec(A[:h, :h], nb, out[:h, :h])
    L21T = torch.linalg.solve_triangular(out[:h, :h], A[:h, h:], upper=False)
    out[h:, :h] = L21T.T
    W = L21T.to(torch.float64)
    del L21T
    S = torch.addmm(A[h:, h:].to(torch.float64), W.T, W,
                    alpha=-1.0).to(A.dtype)
    del W
    _chol_rec(S, nb, out[h:, h:])


def chol_recursive(K, nb: int = 2048, precision=None):
    """Lower Cholesky factor by divide and conquer on (nb, nb) leaves:
    the leaves are `cholesky_ex`, the panels one triangular solve each and
    the Schur update one product, so nearly all n³/3 operations are GEMMs.
    n is padded up to a multiple of nb with the identity, as the JAX
    package does. A leaf that fails is NaN-filled, and the NaNs run on
    through every later panel and leaf, as with `chol_dense`: the factor
    succeeded when it is all finite. `precision` has no effect.

    The Schur update runs in float64 whatever K's dtype. Its one product
    sums n/2 terms that cancel A22 down to the noise floor (an SE Gram's
    Schur complement is ~s²), and in f32 that sum's rounding put the
    factor's backward error ‖K − LLᵀ‖/‖K‖ at 3.1e-6 against cuSOLVER's
    8.5e-7 (H100, n = 16384, bench.py's Gram); in float64, 6.9e-7. On the
    card DGEMM's peak is f32's, so the update costs about the same."""
    n = K.shape[0]
    pad = (-n) % nb
    A = _pad_identity(K, pad) if pad else K
    out = torch.zeros_like(A)
    _chol_rec(A, nb, out)
    return out[:n, :n] if pad else out


def tri_solve_chunked(L, B, chunk: int = 1024, lower: bool = True):
    """Triangular solve L X = B with a wide right-hand side, `chunk`
    columns at a time. Each chunk is copied into its columns of one
    column-major output and solved there in place, so the solve holds
    nothing beyond its output (as torch's single solve does: its peak is
    this one's, PERF.md §6)."""
    n, k = B.shape
    if k <= chunk:
        return torch.linalg.solve_triangular(L, B, upper=not lower)
    out = torch.empty((k, n), dtype=B.dtype, device=B.device).T
    for j in range(0, k, chunk):
        torch.linalg.solve_triangular(L, B[:, j:j + chunk], upper=not lower,
                                      out=out[:, j:j + chunk])
    return out


def solve_psd(K, b, jitter: float | None = None):
    """One-shot PSD solve; returns (x, CholResult) of `safe_cholesky`."""
    res = safe_cholesky(K, jitter)
    return cho_solve(res.L, b), res


def logdet_from_chol(L):
    return 2.0 * torch.sum(torch.log(torch.diagonal(L)))


def chol_rank1_update(L, v):
    """Cholesky factor of L Lᵀ + v vᵀ in O(n²): a Givens-style sweep over
    the columns, each step touching only the rows below its diagonal.
    Returns a new factor; L and v are not modified."""
    L, v = L.clone(), v.clone()
    n = L.shape[0]
    for k in range(n):
        Lkk, vk = L[k, k], v[k]
        r = torch.sqrt(Lkk * Lkk + vk * vk)
        c, s = r / Lkk, vk / Lkk
        L[k, k] = r
        if k + 1 < n:
            col = (L[k + 1:, k] + s * v[k + 1:]) / c
            v[k + 1:] = c * v[k + 1:] - s * col
            L[k + 1:, k] = col
    return L


def woodbury_inv_update(Vinv, u):
    """(V + u uᵀ)⁻¹ from V⁻¹ by Sherman–Morrison (the primal rank-1 update
    of models/feature_gp.py)."""
    Vu = Vinv @ u
    denom = 1.0 + u @ Vu
    return Vinv - torch.outer(Vu, Vu) / denom


def schur_complement_extend(Kinv, k_new, k_nn):
    """Inverse of the (n+1)² Gram from the n² inverse `Kinv`, the new
    column `k_new` and the new diagonal entry `k_nn` (the dual rank-1
    growth). A Schur complement s below 1e-12 in magnitude is taken as
    1e-12."""
    a = Kinv @ k_new
    s = k_nn - k_new @ a
    s = torch.where(torch.abs(s) < 1e-12, torch.full_like(s, 1e-12), s)
    n = Kinv.shape[0]
    out = torch.empty((n + 1, n + 1), dtype=Kinv.dtype, device=Kinv.device)
    torch.add(Kinv, torch.outer(a, a) / s, out=out[:n, :n])
    out[:n, n] = -a / s
    out[n, :n] = -a / s
    out[n, n] = 1.0 / s
    return out


def power_iteration(A, iters: int = 50, generator=None):
    """Top eigenvalue of a symmetric PSD matrix by `iters` power steps from
    the normalised ones vector, or from a normal draw of `generator`."""
    n = A.shape[0]
    if generator is None:
        v = torch.ones(n, dtype=A.dtype, device=A.device) / n ** 0.5
    else:
        v = torch.randn(n, generator=generator, dtype=A.dtype,
                        device=generator.device).to(A.device)
        v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = A @ v
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    return v @ (A @ v)


def symsqrt(A, inv: bool = False, eps: float = 1e-12):
    """Symmetric (inverse) square root V·diag(w^±½)·Vᵀ of A through its
    eigendecomposition, eigenvalues clipped at `eps`. The eigh runs in
    float64 whatever A's dtype and the result is returned in A's dtype:
    cuSOLVER's f32 eigh leaves V orthonormal only to ~1e-4 at a few hundred
    (ROADMAP Queue 3), which the clipped inverse root would amplify."""
    w, V = torch.linalg.eigh(A.to(torch.float64))
    w = torch.clamp(w, min=eps)
    s = 1.0 / torch.sqrt(w) if inv else torch.sqrt(w)
    return ((V * s) @ V.T).to(A.dtype)
