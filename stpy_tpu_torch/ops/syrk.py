"""Lower-triangle symmetric rank-k update and the fast blocked Cholesky on it.

Port of stpy_tpu/ops/pallas_syrk.py (`syrk_update_lower`, `_leaf_chol`,
`chol_blocked_syrk`), the factorization behind `linalg.chol_dense(K,
fast=True)`. A right-looking Cholesky only reads the lower triangle of its
trailing matrix, so its update T ← T − W·Wᵀ needs only the entries i ≥ j:
half the work of a dense product. For CUDA tensors `syrk_update_lower_`
launches csrc/syrk_lower.cu; for CPU tensors it runs
`syrk_update_lower_plain_`, the same update in PyTorch (f32 sums), one row
block at a time.

The JAX kernel splits W into bf16 halves (`split_bf16`) because the TPU has
no f32 matrix mode, and keeps three of the four products, hi·hiᵀ + hi·loᵀ +
lo·hiᵀ. The card kernel keeps the same three terms with TF32 halves on the
tensor cores (`split_tf32` is its split: 11-bit halves against bf16's 8, so
the product is finer than the reference's), summing in f32.

Memory: `chol_blocked_syrk` copies A's lower triangle once into the output
and factors there, as LAPACK's potrf does: each diagonal block is factored
in place (`ops.chol_leaf.chol_leaf_`), each panel W is written over the
panel, and the trailing block is updated in place through a view whose
rows are strided, so the peak is A plus one factor and one panel, and, on
the card, the kernel's split of the panel (8·m·k bytes, 235 MB at the
16k factor's first update).
"""
from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.chol_leaf import MAX_LEAF, chol_leaf_

# csrc/syrk_lower.cu's split of W: 128-row bands in 32-deep k-tiles
SYRK_BAND, SYRK_TILE_K = 128, 32


def _tf32_bits(x):
    """cvt.rna.tf32.f32's rounding of float32 x (to nearest, ties away from
    zero, onto 10 mantissa bits), as csrc/wgmma_tf32.cuh's `to_tf32`: the
    bits plus 0x1000, the 13 low bits cleared, in integer ops."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(W):
    """The card kernel's split of float32 W into TF32 halves (hi, lo):
    hi = tf32(W), lo = tf32(W − hi), so |W − hi − lo| ≤ 2⁻²²|W|. Plain
    PyTorch, any device."""
    hi = _tf32_bits(W)
    return hi, _tf32_bits(W - hi)


def syrk_update_lower_plain_(T, W, block: int = 512):
    """Plain PyTorch version of the kernel, in place: for each block of
    `block` rows, T[i, :i1] −= W[i]·W[:i1]ᵀ, restricted to i ≥ j on the
    diagonal block. The strict upper triangle is left as it was."""
    m = T.shape[0]
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        upd = W[i0:i1] @ W[:i1].T
        T[i0:i1, :i0] -= upd[:, :i0]
        T[i0:i1, i0:i1] -= torch.tril(upd[:, i0:])
    return T


def syrk_update_lower_(T, W, block: int = 512):
    """In place: T[i, j] −= (W·Wᵀ)[i, j] for every i ≥ j; the strict upper
    triangle of T is neither read nor written. T (m, m) may be a view whose
    rows are strided (the trailing block of a factor); W (m, k) must not
    overlap T. `block` sets the plain version's row blocks. CUDA: the hand
    kernel (float32, the product on the TF32 tensor cores in three passes,
    see `split_tf32`; it allocates its split of W, 8·m·k bytes); CPU:
    `syrk_update_lower_plain_`. Returns T."""
    if (T.dim() != 2 or W.dim() != 2 or T.shape[0] != T.shape[1]
            or W.shape[0] != T.shape[0]):
        raise ValueError(f"syrk_update_lower: shapes {tuple(T.shape)} and "
                         f"{tuple(W.shape)}, not (m, m) and (m, k)")
    m, k = W.shape
    if not T.is_cuda:
        return syrk_update_lower_plain_(T, W, block)
    check_cuda_inputs("syrk_lower", torch.float32, T, W)
    if m > 1 and (T.stride(1) != 1 or T.stride(0) < m):
        raise ValueError("syrk_update_lower_: the kernel updates rows of unit "
                         f"stride in place, got strides {T.stride()}")
    if W.stride(1) != 1 or W.stride(0) < k:
        W = W.contiguous()
    if m == 0 or k == 0:
        return T
    split = (-(-m // SYRK_BAND) * -(-k // SYRK_TILE_K)
             * SYRK_BAND * SYRK_TILE_K)
    wh, wl = torch.empty((2, split), dtype=torch.float32, device=T.device)
    lib = _build.library()
    with torch.cuda.device(T.device):
        err = lib.stpy_syrk_lower(
            T.data_ptr(), W.data_ptr(), wh.data_ptr(), wl.data_ptr(), m, k,
            max(T.stride(0), m), W.stride(0),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "syrk_lower")
    syrk_update_lower_.launches += 1
    return T


syrk_update_lower_.launches = 0


def syrk_update_lower(T, W, block: int = 512, block_k: int = 512):
    """T − W·Wᵀ on the lower triangle, as a new tensor; callers must treat
    the strict upper triangle as undefined (here it is T's). T: (m, m),
    W: (m, k). The JAX signature (`block_k`, the TPU kernel's k tile, has
    no effect); `syrk_update_lower_` updates in place."""
    return syrk_update_lower_(T.clone(memory_format=torch.contiguous_format),
                              W, block)


def _leaf_chol_(T):
    """In place: the lower factor of a diagonal block, upper triangle 0. Up
    to 1024 one `chol_leaf_` launch; above, split once into halves:
    L11 = leaf(T11), Linv = L11⁻¹, L21 = T21·Linvᵀ, leaf(T22 − L21·L21ᵀ)."""
    n = T.shape[0]
    if n <= MAX_LEAF:
        return chol_leaf_(T)
    h = n // 2
    T11, T21, T22 = T[:h, :h], T[h:, :h], T[h:, h:]
    _leaf_chol_(T11)
    eye = torch.eye(h, dtype=T.dtype, device=T.device)
    Linv = torch.linalg.solve_triangular(T11, eye, upper=False)
    T21.copy_(T21 @ Linv.T)
    T22.addmm_(T21, T21.T, alpha=-1.0)
    _leaf_chol_(T22)
    T[:h, h:].zero_()
    return T


def chol_blocked_syrk(A, nb: int = 2048, block: int = 512,
                      panel_precision=None):
    """Right-looking blocked Cholesky, in float32, with the lower-only
    trailing update: for each nb-column block, the leaf factor of its
    diagonal block (`_leaf_chol_`), Linv = Ljj⁻¹ by a triangular solve, the
    panel W = B·Linvᵀ (torch.matmul in full f32), and T ← T − W·Wᵀ on the
    trailing block (`syrk_update_lower_`). n is padded up to a multiple of
    nb with an identity block. Only the lower triangle of A is read; the
    factor's upper triangle is explicitly zero (zeroed once when A's lower
    triangle is copied in, and written by nothing after). `panel_precision`
    (the TPU's bf16-pass count of the panel product) has no effect.
    Inference only: no autograd. CUDA: A must be float32."""
    if A.is_cuda and A.dtype != torch.float32:
        raise TypeError("chol_blocked_syrk: the fast factorization runs its "
                        f"hand kernels in float32, got {A.dtype}")
    n = A.shape[0]
    N = n + (-n) % nb
    L = torch.empty((N, N), dtype=torch.float32, device=A.device)
    L[:n, :n].copy_(A)
    if N > n:
        L[n:].zero_()
        L[n:, n:].diagonal().fill_(1.0)
    L.tril_()
    if N <= nb:
        _leaf_chol_(L)
    else:
        eye = torch.eye(nb, dtype=L.dtype, device=L.device)
        for s in range(0, N, nb):
            D = L[s:s + nb, s:s + nb]
            _leaf_chol_(D)
            if s + nb < N:
                Linv = torch.linalg.solve_triangular(D, eye, upper=False)
                W = L[s + nb:, s:s + nb]
                W.copy_(W @ Linv.T)
                syrk_update_lower_(L[s + nb:, s + nb:], W, block)
    return L if N == n else L[:n, :n].contiguous()
