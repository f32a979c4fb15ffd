"""Double-float (hi, lo) Gram for the SE, half-integer Matérn and Laplace
(L1) families.

Port of stpy_tpu/ops/pallas_gram_df.py (`gram_df`, `gram_se_df`,
`gram_matern_df`, `_df_add`, `_df_mul`).
The contract is unchanged: two f32 arrays with hi + lo = k(x, y) to f64
accuracy, hi = f32(k). The TPU builds the pair from f32 error-free
transforms because it has no f64; the card computes k in FP64 and splits it.

1/γ is taken in f64 from the f64 hyperparameters and the coordinates are
scaled in f64 before the kernel — what the host split at
pallas_gram_df.py:549-581 intends — so an f32-inexact γ such as 1.1 keeps its
full value (the JAX package needs lo-limb shadows for that; the port does
not). For CUDA tensors `gram_df_scaled` launches csrc/gram_df.cu; for CPU
tensors it runs `gram_df_plain`.

The L1 family ("laplace", shape code `L1_CODE`) is the single tier's Laplace
kernel κ·exp(−‖x − y‖₁/γ²) in double-float: coordinates scaled by 1/γ² in
f64, |x_c − y_c| summed in FP64. The JAX package's double tier has no such
family and maps laplace to the L2 Matérn-½ instead (ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.gram import shape_code


# csrc/gram_df_entry.cuh:SHAPE_L1, beside ops/gram.py:SHAPE_CODES
L1_CODE = 4


def split_f64(k: torch.Tensor):
    """(hi, lo) f32 pair of an f64 tensor: hi = f32(k), lo = f32(k − hi)."""
    hi = k.to(torch.float32)
    return hi, (k - hi.to(torch.float64)).to(torch.float32)


def _sq_f64(xs, ys):
    """Squared distances of f64 coordinates, summed feature by feature."""
    sq = torch.zeros((xs.shape[0], ys.shape[0]), dtype=torch.float64,
                     device=xs.device)
    for c in range(xs.shape[1]):
        t = xs[:, c, None] - ys[None, :, c]
        sq.addcmul_(t, t)
    return sq


def _l1_f64(xs, ys):
    """L1 distances of f64 coordinates, summed feature by feature."""
    d1 = torch.zeros((xs.shape[0], ys.shape[0]), dtype=torch.float64,
                     device=xs.device)
    for c in range(xs.shape[1]):
        d1.add_(torch.abs(xs[:, c, None] - ys[None, :, c]))
    return d1


def _t_f64(sq, family, nu):
    """The entry's exponent, as csrc/gram_df_entry.cuh:df_t: √(2ν·sq) for
    Matérn, sq/2 for SE."""
    if family == "se":
        return 0.5 * sq
    return torch.sqrt(2.0 * nu * sq + 1e-300)


def _kernel_f64(sq: torch.Tensor, kappa: float, family: str, nu: float):
    t = _t_f64(sq, family, nu)
    K = torch.exp(-t)
    if family == "matern" and nu == 1.5:
        K = (1.0 + t) * K
    elif family == "matern" and nu == 2.5:
        K = (1.0 + t + t * t / 3.0) * K
    return kappa * K


def gram_df_plain(xs, ys, kappa, family="se", nu=1.5):
    """Plain PyTorch version of the kernel: f64 differences, shape and κ,
    split into an f32 pair."""
    if family == "laplace":
        return split_f64(float(kappa) * torch.exp(-_l1_f64(xs, ys)))
    return split_f64(_kernel_f64(_sq_f64(xs, ys), float(kappa), family, nu))


def gram_df_scaled(xs, ys, kappa, family="se", nu=1.5):
    """(hi, lo) Gram of f64 coordinates already scaled by 1/γ (1/γ² for
    "laplace"). CUDA: the hand kernel, which computes K(xs, xs) from its
    lower half where ys is xs; CPU: `gram_df_plain`."""
    code = L1_CODE if family == "laplace" else shape_code(family, nu)
    if not xs.is_cuda:
        return gram_df_plain(xs, ys, kappa, family, nu)
    check_cuda_inputs("gram_df", torch.float64, xs, ys)
    xs, ys = xs.contiguous(), ys.contiguous()
    n, d = xs.shape
    m = ys.shape[0]
    hi = torch.empty((n, m), dtype=torch.float32, device=xs.device)
    lo = torch.empty_like(hi)
    if n == 0 or m == 0:
        return hi, lo
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.stpy_gram_df(
            xs.data_ptr(), ys.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            n, m, d, float(kappa), code,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_df")
    gram_df_scaled.launches += 1
    return hi, lo


gram_df_scaled.launches = 0


def gram_df(x, y, gamma, kappa=1.0, *, family="se", nu=1.5):
    """Double-float Gram (hi, lo), f32 each, with hi + lo = k(x, y).

    family "se": κ·exp(−‖x−y‖²/(2γ²)); "matern": κ·P_ν(t)·e^{−t} with
    t = √(2ν)·‖x−y‖/γ and ν ∈ {½, 3/2, 5/2}; "laplace": κ·exp(−‖x−y‖₁/γ²).
    γ is a scalar or per-dim (ARD).
    """
    if family not in ("se", "matern", "laplace"):
        raise NotImplementedError(f"df gram family {family!r}")
    if family == "laplace":
        g = torch.as_tensor(gamma, dtype=torch.float64, device=x.device)
        gamma = g * g
    xs = scale_coords(x, gamma)
    # one tensor for K(x, x): the kernel then computes its lower half only
    ys = xs if y is x else scale_coords(y, gamma)
    return gram_df_scaled(xs, ys, kappa, family, float(nu))


def gram_se_df(x, y, gamma, kappa=1.0, *, block_m=256, block_n=256):
    """Double-float SE Gram (see `gram_df`). block_m and block_n, the JAX
    package's VMEM tile, are accepted and ignored: csrc/gram_df.cu's tile
    is fixed."""
    return gram_df(x, y, gamma, kappa, family="se")


def gram_matern_df(x, y, gamma, kappa=1.0, *, nu=1.5, block_m=256,
                   block_n=256):
    """Double-float Matérn Gram, ν ∈ {½, 3/2, 5/2} (see `gram_df`);
    block_m and block_n are accepted and ignored, as in `gram_se_df`."""
    return gram_df(x, y, gamma, kappa, family="matern", nu=nu)


def scale_coords(x, gamma):
    """x·(1/γ) in f64, 1/γ taken in f64 (γ scalar or per-dim): the
    coordinates `gram_df` hands its kernel."""
    g = torch.as_tensor(gamma, dtype=torch.float64, device=x.device)
    inv = 1.0 / torch.broadcast_to(g.reshape(-1), (x.shape[1],))
    return x.to(torch.float64) * inv


def df_add(xh, xl, yh, yl):
    """(x + y) of two df pairs, summed in f64 and split again."""
    x = xh.to(torch.float64) + xl.to(torch.float64)
    return split_f64(x + (yh.to(torch.float64) + yl.to(torch.float64)))


def df_mul(xh, xl, yh, yl):
    """(x · y) of two df pairs, multiplied in f64 and split again."""
    x = xh.to(torch.float64) + xl.to(torch.float64)
    return split_f64(x * (yh.to(torch.float64) + yl.to(torch.float64)))
