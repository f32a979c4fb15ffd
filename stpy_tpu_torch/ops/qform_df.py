"""Fused double-float quadratic form for the refined predictive variance.

Port of stpy_tpu/ops/pallas_qform_df.py (`qform_refined`,
`qform_refined_strip`). For the regularized df Gram A = Th + Tl + s²I and an
approximate solve W0 ≈ A⁻¹B of the df cross Gram B = Bh + Bl (columns = test
points),

    q[j] = Σ_a W0[a,j]·(2B − (Th + Tl)·W0 − s²W0)[a,j] = 2bᵀw0 − w0ᵀA w0
         = bᵀA⁻¹b − δᵀAδ,   δ = A⁻¹b − w0,

so the quadratic form that the predictive variance subtracts is recovered
with an error second order in W0's residual, and on the side that
over-estimates the variance. For CUDA tensors `qform_refined_strip` launches
csrc/qform_df.cu (f32 operands, FP64 inside); for CPU tensors it runs
`qform_df_plain`, the f64 evaluation of the JAX package's x64 branch
(`_qform_f64`, pallas_qform_df.py:351-364).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs


def qform_df_plain(Th, Tl, W0k, W0a, Bh, Bl, s2):
    """Plain PyTorch version of the kernel: q in f64, split into a pair of
    the input dtype (hi holds f32(q), as the JAX x64 branch)."""
    f64 = torch.float64
    A = Th.to(f64) + Tl.to(f64)
    Wa = W0a.to(f64)
    B = Bh.to(f64) + Bl.to(f64)
    u = 2.0 * B - A @ W0k.to(f64) - s2 * Wa
    q = torch.sum(Wa * u, dim=0)
    hi = q.to(torch.float32).to(f64)
    return hi.to(Th.dtype), (q - hi).to(Th.dtype)


def qform_refined(Th, Tl, W0, Bh, Bl, s):
    """q ≈ diag(Bᵀ(Th + Tl + s²I)⁻¹B) as a pair (qh, ql) of shape (t,),
    given an approximate solve W0. Th, Tl: (n, n) df Gram; W0, Bh, Bl:
    (n, t); s: noise std."""
    W0 = W0.contiguous()   # one row-major copy serves both operands
    return qform_refined_strip(Th, Tl, W0, W0, Bh, Bl, s)


def qform_refined_strip(Th, Tl, W0k, W0a, Bh, Bl, s):
    """Row-strip form: Th, Tl are the (c, n) df Gram rows of one row chunk,
    W0k the full (n, t) solve, W0a, Bh, Bl the chunk's (c, t) rows. Returns
    the strip's share (qh, ql) of the column sums; the strips of a
    partition of the rows add up to the square call. CUDA: the hand kernel
    (f32 operands; transposed views are copied to row-major first); CPU:
    `qform_df_plain`."""
    c, n = Th.shape
    t = W0k.shape[1]
    if (Tl.shape != (c, n) or W0k.shape != (n, t)
            or any(a.shape != (c, t) for a in (W0a, Bh, Bl))):
        raise ValueError(
            "qform_refined_strip: shapes "
            + ", ".join(str(tuple(a.shape)) for a in (Th, Tl, W0k, W0a, Bh, Bl))
        )
    s2 = float(s) ** 2
    if not Th.is_cuda:
        return qform_df_plain(Th, Tl, W0k, W0a, Bh, Bl, s2)
    check_cuda_inputs("qform_df", torch.float32, Th, Tl, W0k, W0a, Bh, Bl)
    ops = [a.contiguous() for a in (Th, Tl, W0k, W0a, Bh, Bl)]
    qh = torch.empty(t, dtype=torch.float32, device=Th.device)
    ql = torch.empty_like(qh)
    if t == 0:
        return qh, ql
    if c == 0:
        return qh.zero_(), ql.zero_()
    lib = _build.library()
    part = torch.empty((lib.stpy_qform_df_row_tiles(c), t),
                       dtype=torch.float64, device=Th.device)
    with torch.cuda.device(Th.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stpy_qform_df(*(a.data_ptr() for a in ops), s2,
                                part.data_ptr(), c, n, t, stream)
        _build.check(err, "qform_df")
        err = lib.stpy_qform_df_reduce(part.data_ptr(), part.shape[0], t,
                                       qh.data_ptr(), ql.data_ptr(), stream)
    _build.check(err, "qform_df reduction")
    qform_refined_strip.launches += 1
    return qh, ql


qform_refined_strip.launches = 0
