"""Fused Gram K(x, y) = κ·shape(max(‖x‖² + ‖y‖² − 2x·yᵀ, 0)).

Port of stpy_tpu/ops/pallas_gram.py (`gram_se`, `gram_matern`, `gram`). The
1/γ scaling (scalar or ARD) happens here, outside the kernel, as in
`pallas_gram._gram`. For CUDA tensors `gram_scaled` launches the hand-written
kernel csrc/gram.cu (f32 only); for CPU tensors it runs `gram_plain`, the
same formula in PyTorch (any float dtype). Where an input needs a gradient,
`gram_se` and `gram_matern` go through `_Gram`, whose backward is the JAX
package's closed form (`pallas_gram._gram_bwd`).
"""

from __future__ import annotations

import math

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops import check_cuda_inputs, needs_grad

# (family, nu) -> the shape code of csrc/gram.cu and csrc/gram_df.cu
SHAPE_CODES = {
    ("se", None): 0,
    ("matern", 0.5): 1,
    ("matern", 1.5): 2,
    ("matern", 2.5): 3,
}
# the shape functions of the matrix-free products (csrc/gram_matvec.cu,
# csrc/gram_matmat.cu), as stpy_tpu/ops/pallas_gram_matvec.py:_SHAPES: the
# kernel k(sq), k'(sq)·sq and k'(sq). A shape's code is its family's code
# plus 4 times its index here (csrc/gram_shape.cuh); the other kernels take
# "k" only.
SHAPES = ("k", "dk_sq", "dk")

# distance eps: keeps sqrt finite at coincident points (as pallas_gram._EPS)
_EPS = 1e-30


def shape_code(family: str, nu: float, shape: str = "k") -> int:
    key = (family, None if family == "se" else float(nu))
    if key not in SHAPE_CODES:
        raise NotImplementedError(
            f"fused Gram for family={family!r}, nu={nu}: only SE and Matérn "
            "nu in (0.5, 1.5, 2.5) are fused (ROADMAP Queue 1 item 7)"
        )
    if shape not in SHAPES:
        raise ValueError(f"shape={shape!r}: not one of {SHAPES}")
    return SHAPE_CODES[key] + len(SHAPE_CODES) * SHAPES.index(shape)


def gram_plain(xs, ys, kappa, family="se", nu=1.5):
    """Plain PyTorch version of the kernel: same formula, any dtype."""
    sq = F.sq_dist(xs, ys)
    if family == "se":
        K = F.se_shape(sq)
    else:
        K = F.matern_shape(torch.sqrt(sq + _EPS), nu)
    return _as_factor(kappa, K) * K


def gram_scaled(xs, ys, kappa, family="se", nu=1.5):
    """Gram of coordinates already scaled by 1/γ. CUDA: the hand kernel;
    CPU: `gram_plain`."""
    code = shape_code(family, nu)
    if not xs.is_cuda:
        return gram_plain(xs, ys, kappa, family, nu)
    check_cuda_inputs("gram", torch.float32, xs, ys)
    xs, ys = xs.contiguous(), ys.contiguous()
    n, d = xs.shape
    m = ys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=xs.device)
    if n == 0 or m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.stpy_gram_f32(
            xs.data_ptr(), ys.data_ptr(), out.data_ptr(), n, m, d,
            float(kappa), code, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram")
    gram_scaled.launches += 1
    return out


gram_scaled.launches = 0


def _as_factor(v, like: torch.Tensor):
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return v


def as_scalar_tensor(v, like: torch.Tensor) -> torch.Tensor:
    """`v` as a tensor of `like`'s dtype and device (a graph-keeping cast
    where `v` is a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return torch.tensor(float(v), dtype=like.dtype, device=like.device)


def shape_and_slope(sq, family, nu):
    """(k(sq), dk/dsq) of a squared scaled distance, as
    stpy_tpu/ops/pallas_gram.py:_gram_bwd forms them."""
    if family == "se":
        K = torch.exp(-0.5 * sq)
        return K, -0.5 * K
    r = torch.sqrt(sq + _EPS)
    if nu == 0.5:
        K = torch.exp(-r)
        return K, -K / (2.0 * r)
    if nu == 1.5:
        e = torch.exp(-math.sqrt(3.0) * r)
        return (1.0 + math.sqrt(3.0) * r) * e, -1.5 * e
    k = math.sqrt(5.0) * r
    e = torch.exp(-k)
    return (1.0 + k + k * k / 3.0) * e, -(5.0 / 6.0) * (1.0 + k) * e


class _Gram(torch.autograd.Function):
    """K = κ·k(sq(xs, ys)) of scaled coordinates, differentiable in xs, ys
    and κ. The forward is `gram_scaled` on detached inputs (a launch of
    csrc/gram.cu on the card). The backward is the closed form of
    stpy_tpu/ops/pallas_gram.py:_gram_bwd, W = ḡ·κ·k'(sq):
      x̄s = 2(rowsum(W)∘xs − W·ys),  ȳs = 2(colsum(W)∘ys − Wᵀ·xs),
      κ̄ = Σ ḡ∘k(sq).
    It is written in differentiable torch ops, so it has a backward of its
    own (Newton's Hessian is reverse over reverse). γ is not an input:
    its gradient, scalar or ARD, flows through xs = x/γ by autograd, the
    quantity of `_gram_bwd`'s d_gamma without its (n, m, d) tensor."""

    @staticmethod
    def forward(ctx, xs, ys, kappa, family, nu):
        ctx.save_for_backward(xs, ys, kappa)
        ctx.family, ctx.nu = family, nu
        return gram_scaled(xs.detach(), ys.detach(), kappa.detach(), family, nu)

    @staticmethod
    def backward(ctx, g):
        xs, ys, kappa = ctx.saved_tensors
        K, dK = shape_and_slope(F.sq_dist(xs, ys), ctx.family, ctx.nu)
        W = g * kappa * dK
        d_xs = 2.0 * (W.sum(dim=1, keepdim=True) * xs - W @ ys)
        d_ys = 2.0 * (W.sum(dim=0)[:, None] * ys - W.T @ xs)
        return d_xs, d_ys, torch.sum(g * K), None, None


def gram_scaled_ad(xs, ys, kappa, family="se", nu=1.5):
    """`gram_scaled`, through `_Gram` where an input needs a gradient;
    otherwise the plain call, so the serving path is unchanged."""
    if needs_grad(xs, ys, kappa):
        return _Gram.apply(xs, ys, as_scalar_tensor(kappa, xs), family, nu)
    return gram_scaled(xs, ys, kappa, family, nu)


def gram_se(x, y, gamma, kappa=1.0):
    """Fused SE Gram κ·exp(−‖x−y‖²/(2γ²)); γ scalar or per-dim (ARD)."""
    g = _as_factor(gamma, x)
    return gram_scaled_ad(x / g, y / g, kappa, "se")


def gram_matern(x, y, gamma, kappa=1.0, nu=1.5):
    """Fused Matérn Gram for ν ∈ {½, 3/2, 5/2}."""
    g = _as_factor(gamma, x)
    return gram_scaled_ad(x / g, y / g, kappa, "matern", nu)


def gram(x, y, *, family="se", gamma=1.0, kappa=1.0, nu=1.5):
    if family in ("se", "ard"):
        return gram_se(x, y, gamma, kappa)
    if family == "matern":
        return gram_matern(x, y, gamma, kappa, nu)
    if family == "laplace":
        from stpy_tpu_torch.ops.gram_l1 import gram_laplace

        return gram_laplace(x, y, gamma, kappa)
    raise NotImplementedError(family)
