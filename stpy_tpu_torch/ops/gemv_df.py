"""Exact double-float GEMV (Ah + Al)·(v + vl) → (hi, lo).

Port of stpy_tpu/ops/pallas_gemv_df.py (`gemv_df_fused`) and of
stpy_tpu/ops/compensated.py:gemv_df, its entry point. For CUDA tensors
`gemv_df` launches csrc/gemv_df.cu (f32 only), which sums in FP64; for CPU
tensors it runs `gemv_df_plain`, the f64 GEMV of the JAX package's x64
branch (pallas_gemv_df.py:169-174).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs


def gemv_df_plain(Ah, Al, v, vl):
    """Plain PyTorch version of the kernel: the f64 GEMV split into a pair
    of the input dtype (hi holds f32(r), as the JAX x64 branch)."""
    r = (Ah.to(torch.float64) + Al.to(torch.float64)) @ (
        v.to(torch.float64) + vl.to(torch.float64))
    hi = r.to(torch.float32).to(torch.float64)
    return hi.to(Ah.dtype), (r - hi).to(Ah.dtype)


def gemv_df(Ah, Al, v, vl=None):
    """(hi, lo) of shape (m,) with hi + lo = (Ah + Al)·(v + vl).

    Ah, Al: (m, k); v, vl: (k,) or (k, 1); vl defaults to zeros. CUDA: the
    hand kernel; CPU: `gemv_df_plain`."""
    v = v.reshape(-1)
    vl = torch.zeros_like(v) if vl is None else vl.reshape(-1)
    m, k = Ah.shape
    if Al.shape != Ah.shape or v.shape[0] != k or vl.shape[0] != k:
        raise ValueError(
            f"gemv_df: shapes {tuple(Ah.shape)}, {tuple(Al.shape)}, "
            f"{tuple(v.shape)}, {tuple(vl.shape)}"
        )
    if not Ah.is_cuda:
        return gemv_df_plain(Ah, Al, v, vl)
    check_cuda_inputs("gemv_df", torch.float32, Ah, Al, v, vl)
    Ah, Al, v, vl = (t.contiguous() for t in (Ah, Al, v, vl))
    oh = torch.empty(m, dtype=torch.float32, device=Ah.device)
    ol = torch.empty_like(oh)
    if m == 0:
        return oh, ol
    lib = _build.library()
    with torch.cuda.device(Ah.device):
        err = lib.stpy_gemv_df(
            Ah.data_ptr(), Al.data_ptr(), v.data_ptr(), vl.data_ptr(),
            oh.data_ptr(), ol.data_ptr(), m, k,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gemv_df")
    gemv_df.launches += 1
    return oh, ol


gemv_df.launches = 0


def gemv_df_fused(Ah, Al, v, *, block_m=512, block_k=1024, vl=None):
    """`gemv_df` under the JAX package's name and signature
    (pallas_gemv_df.py:gemv_df_fused). block_m and block_k, its VMEM tile,
    are accepted and ignored: csrc/gemv_df.cu picks its own."""
    return gemv_df(Ah, Al, v, vl)
