"""Laplace (L1) Gram K(x, y) = κ·exp(−‖x − y‖₁/γ²).

Port of stpy_tpu/ops/pallas_gram.py (`gram_laplace`, `_gram_l1_pallas`). For
CUDA tensors `gram_l1` launches the hand-written kernel csrc/gram_l1.cu (f32
only); for CPU tensors it runs `gram_l1_plain`, the same formula in PyTorch
(any float dtype, differentiable).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.gram import _as_factor


def gram_l1_plain(x, y, inv_g2, kappa):
    """Plain PyTorch version of the kernel: L1 distances by `torch.cdist`,
    then κ·exp(−inv_g2·D)."""
    return _as_factor(kappa, x) * F.laplace_shape(
        F.manhattan_dist(x, y) * _as_factor(inv_g2, x))


def gram_l1(x, y, inv_g2, kappa):
    """κ·exp(−inv_g2·‖x_i − y_j‖₁), (n, m). CUDA: the hand kernel; CPU:
    `gram_l1_plain`."""
    if not x.is_cuda:
        return gram_l1_plain(x, y, inv_g2, kappa)
    check_cuda_inputs("gram_l1", torch.float32, x, y)
    x, y = x.contiguous(), y.contiguous()
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.stpy_gram_l1(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
            float(kappa), float(inv_g2),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_l1")
    gram_l1.launches += 1
    return out


gram_l1.launches = 0


def gram_laplace(x, y, gamma, kappa=1.0):
    """Fused Laplace Gram κ·exp(−manhattan(x, y)/γ²); γ scalar."""
    return gram_l1(x, y, 1.0 / (gamma * gamma), kappa)
