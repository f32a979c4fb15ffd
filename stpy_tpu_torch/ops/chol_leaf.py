"""Cholesky factor of one SPD leaf block of up to 1024², in one kernel launch.

Port of stpy_tpu/ops/pallas_chol.py (`chol_leaf`), the leaf of the fast
blocked factorization (`ops/syrk.chol_blocked_syrk`). For CUDA tensors
`chol_leaf` / `chol_leaf_` launch csrc/chol_leaf.cu (float32, n ≤ 1024,
rows of unit stride): one cooperative launch whose blocks share every
32-column panel, `chol_leaf_grid(n)` of them; for CPU tensors they run
`chol_leaf_plain`, the same right-looking 32-column panel algorithm in
PyTorch ops, in float32.

Only the lower triangle of the input is read; the factor's strict upper
triangle is exactly 0. A pivot that is not positive gives NaN (sqrt of a
negative) or inf (1/0), which spreads through the rest of the factor, as
the JAX kernel's 1/sqrt(d) does, so `safe_cholesky`'s isfinite test sees
the failure.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs

MAX_LEAF = 1024   # the largest leaf the kernel takes
PANEL = 32        # panel width of the kernel and of the plain version


def chol_leaf_plain(A):
    """Plain PyTorch version of the kernel, in float32: for each 32-column
    panel, the column-by-column factorization of the panel (its diagonal
    block and the rows below it), then the trailing update
    A22 ← A22 − P2·P2ᵀ by one matmul."""
    L = A.to(torch.float32, copy=True)
    n = L.shape[0]
    for s in range(0, n, PANEL):
        w = min(PANEL, n - s)
        P = L[s:, s:s + w]
        for c in range(w):
            d = torch.sqrt(P[c, c])          # NaN if the pivot is < 0
            l = P[c + 1:, c] * (1.0 / d)
            P[c + 1:, c + 1:] -= torch.outer(l, l[:w - c - 1])
            P[c, c] = d
            P[c + 1:, c] = l
        if w < n - s:
            P2 = P[w:]
            L[s + w:, s + w:] -= P2 @ P2.T
    return torch.tril(L)


def _leaf_size(A) -> int:
    """n of a leaf the CUDA kernel takes in place; raises otherwise."""
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"chol_leaf: a square matrix, got shape {tuple(A.shape)}")
    n = A.shape[0]
    if n > MAX_LEAF:
        raise ValueError(
            f"chol_leaf: n = {n} > {MAX_LEAF}, the largest leaf the kernel "
            "takes; larger blocks go through ops.syrk._leaf_chol_")
    if n > 1 and (A.stride(1) != 1 or A.stride(0) < n):
        raise ValueError(
            "chol_leaf: the kernel updates rows of unit stride in place, got "
            f"strides {A.stride()}")
    return n


def chol_leaf_grid(n: int) -> int:
    """Blocks of the kernel's cooperative launch for an n-leaf on the
    current CUDA device: one on each SM, capped by the most tiles one panel
    step offers."""
    grid = _build.library().stpy_chol_leaf_grid(n)
    if grid < 0:
        _build.check(-grid, "chol_leaf_grid")
    return grid


def chol_leaf_(A):
    """In place: A ← its lower Cholesky factor, upper triangle 0. A may be a
    view whose rows are strided (a diagonal block of a larger matrix). CUDA:
    the hand kernel; CPU: `chol_leaf_plain`. Returns A."""
    if not A.is_cuda:
        return A.copy_(chol_leaf_plain(A))
    check_cuda_inputs("chol_leaf", torch.float32, A)
    n = _leaf_size(A)
    if n == 0:
        return A
    lib = _build.library()
    with torch.cuda.device(A.device):
        err = lib.stpy_chol_leaf(A.data_ptr(), n, A.stride(0) if n > 1 else 1,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "chol_leaf")
    chol_leaf_.launches += 1
    return A


chol_leaf_.launches = 0


def chol_leaf(A, bp: int = 128):
    """Lower Cholesky factor of an SPD block, n ≤ 1024 on the card, as a new
    tensor. `bp` is the TPU kernel's panel width (128, the MXU tile), kept
    for signature parity; the card's panels are 32 wide. CUDA: A must be a
    contiguous float32 square matrix (it raises otherwise), copied once and
    factored in place by the hand kernel; CPU: `chol_leaf_plain`."""
    if not A.is_cuda:
        return chol_leaf_plain(A)
    check_cuda_inputs("chol_leaf", torch.float32, A)
    _leaf_size(A)
    if not A.is_contiguous():
        raise ValueError("chol_leaf: the CUDA kernel takes a contiguous "
                         "matrix (chol_leaf_ factors a strided view in place)")
    return chol_leaf_(A.clone())
