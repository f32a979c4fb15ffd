"""Laplace (L1) Gram K(x, y) = κ·exp(−‖x − y‖₁/γ²).

Port of stpy_tpu/ops/pallas_gram.py (`gram_laplace`, `_gram_l1_pallas`). For
CUDA tensors `gram_l1` launches the hand-written kernel csrc/gram_l1.cu (f32
only); for CPU tensors it runs `gram_l1_plain`, the same formula in PyTorch
(any float dtype). Where an input needs a gradient, `gram_laplace` goes
through `_GramL1`, whose backward is the JAX package's closed form
(`pallas_gram._gram_l1_bwd`).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops import check_cuda_inputs, needs_grad
from stpy_tpu_torch.ops.gram import _as_factor, as_scalar_tensor


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


class _GramL1(torch.autograd.Function):
    """K = κ·exp(−inv_g2·D), D = ‖x_i − y_j‖₁, differentiable in x, y,
    inv_g2 and κ. The forward is `gram_l1` on detached inputs (a launch of
    csrc/gram_l1.cu on the card). The backward is the closed form of
    stpy_tpu/ops/pallas_gram.py:_gram_l1_bwd, W = ḡ·κ·K·inv_g2:
      x̄_c = −Σ_j W∘sign(x_c − y_c),  ȳ_c = Σ_i W∘sign(x_c − y_c),
      inv_g2̄ = −Σ ḡ·κ·K·D,  κ̄ = Σ ḡ∘K,
    with D and the signs formed a feature at a time (no (n, m, d) tensor).
    It is written in differentiable torch ops, so it has a backward of its
    own. γ's gradient flows through inv_g2 = 1/γ² by autograd."""

    @staticmethod
    def forward(ctx, x, y, inv_g2, kappa):
        ctx.save_for_backward(x, y, inv_g2, kappa)
        return gram_l1(x.detach(), y.detach(), inv_g2.detach(), kappa.detach())

    @staticmethod
    def backward(ctx, g):
        x, y, inv_g2, kappa = ctx.saved_tensors
        d = x.shape[1]
        D = sum((x[:, c:c + 1] - y[:, c]).abs() for c in range(d))
        gK = g * torch.exp(-D * inv_g2)
        W = gK * (kappa * inv_g2)
        d_x, d_y = [], []
        for c in range(d):
            WS = W * torch.sign(x[:, c:c + 1] - y[:, c])
            d_x.append(-WS.sum(dim=1))
            d_y.append(WS.sum(dim=0))
        return (torch.stack(d_x, dim=1), torch.stack(d_y, dim=1),
                -kappa * torch.sum(gK * D), torch.sum(gK))


def gram_laplace(x, y, gamma, kappa=1.0):
    """Fused Laplace Gram κ·exp(−manhattan(x, y)/γ²); γ scalar."""
    inv_g2 = 1.0 / (gamma * gamma)
    if needs_grad(x, y, inv_g2, kappa):
        return _GramL1.apply(x, y, as_scalar_tensor(inv_g2, x),
                             as_scalar_tensor(kappa, x))
    return gram_l1(x, y, inv_g2, kappa)
