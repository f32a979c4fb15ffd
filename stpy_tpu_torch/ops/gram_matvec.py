"""Matrix-free Gram products K(x, y)·v and K(x, y)·V, K never stored.

Port of stpy_tpu/ops/pallas_gram_matvec.py (`gram_matvec`, `gram_matmat`,
`make_lazy_matvec`, `make_lazy_matmat`), shape "k". The 1/γ scaling (scalar
or ARD) happens here, outside the kernels, as in the JAX package. For CUDA
tensors `gram_matvec_scaled` launches csrc/gram_matvec.cu and
`gram_matmat_scaled` launches csrc/gram_matmat.cu (f32 only; the product
with V on the TF32 tensor cores in three passes); for CPU tensors
they run `gram_matvec_plain` / `gram_matmat_plain`, the same function in
PyTorch (any float dtype), which materialises K one row chunk at a time.

The derivative shapes of the JAX kernels ("dk_sq" for γ-gradients, "dk" for
x/y cotangents) and the custom VJP built on them belong to the matrix-free
hyperparameter fit and are not ported yet (ROADMAP Queue 1 item 5): asking
for them raises.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.gram import _as_factor, gram_plain, shape_code

_DERIV = ("the derivative shapes of the matrix-free Gram products belong to "
          "the matrix-free hyperparameter fit, ROADMAP Queue 1 item 5")
# rows of K that the plain versions materialise at a time
_PLAIN_CHUNK = 4096
# csrc/gram_matmat.cu's tile of V: 128 columns (a slab) by 32 rows of y
MATMAT_SLAB, MATMAT_TILE_Y = 128, 32


def _check_shape(shape: str) -> None:
    if shape != "k":
        raise NotImplementedError(f"shape={shape!r}: {_DERIV}")


def gram_matmat_plain(xs, ys, V, kappa, family="se", nu=1.5):
    """Plain PyTorch version of the matmat kernel: K(xs, ys)·V through
    `gram_plain`, one (chunk, m) block of K at a time."""
    if xs.shape[0] == 0:
        return gram_plain(xs, ys, kappa, family, nu) @ V
    return torch.cat([gram_plain(xs[r0:r0 + _PLAIN_CHUNK], ys, kappa, family,
                                 nu) @ V
                      for r0 in range(0, xs.shape[0], _PLAIN_CHUNK)])


def gram_matvec_plain(xs, ys, v, kappa, family="se", nu=1.5):
    """Plain PyTorch version of the matvec kernel: `gram_matmat_plain` of
    the one column v."""
    return gram_matmat_plain(xs, ys, v.reshape(-1, 1), kappa, family, nu)[:, 0]


def _launch_shapes(name, xs, ys, lead):
    n, d = xs.shape
    if ys.shape[1] != d or lead != ys.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(xs.shape)}, "
                         f"{tuple(ys.shape)} and {lead} rows of the right side")
    if d == 0:
        raise ValueError(f"{name}: coordinates with no feature")
    return n, ys.shape[0], d


def gram_matvec_scaled(xs, ys, v, kappa, family="se", nu=1.5):
    """K(xs, ys)·v, (n,), for coordinates already scaled by 1/γ. CUDA: the
    hand kernel; CPU: `gram_matvec_plain`."""
    code = shape_code(family, nu)
    v = v.reshape(-1)
    if not xs.is_cuda:
        return gram_matvec_plain(xs, ys, v, kappa, family, nu)
    check_cuda_inputs("gram_matvec", torch.float32, xs, ys, v)
    n, m, d = _launch_shapes("gram_matvec", xs, ys, v.shape[0])
    xs, ys, v = xs.contiguous(), ys.contiguous(), v.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=xs.device)
    if n == 0 or m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.stpy_gram_matvec(
            xs.data_ptr(), ys.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, m, d, float(kappa), code,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_matvec")
    gram_matvec_scaled.launches += 1
    return out


gram_matvec_scaled.launches = 0


def gram_matmat_scaled(xs, ys, V, kappa, family="se", nu=1.5):
    """K(xs, ys)·V, (n, r), for coordinates already scaled by 1/γ. CUDA: the
    hand kernel, any d, the product with V on the TF32 tensor cores in three
    passes (Kh·Vh + Kh·Vl + Kl·Vh); it allocates V's split, two buffers of
    about m·r floats. Its accuracy, as max |Δ| / Σⱼ|Kᵢⱼ||Vⱼc|: against the
    same function in float64 on the same f32 inputs, the f32 bar
    2·√m·eps32 from about m = 128 y points (coordinates of the lazy
    tiers' scale); below, the f32 entries' own rounding (a few ulps of
    |x|² + |y|² in the squared distance, in any f32 kernel of these
    entries) can exceed it. Against the float64 product of the kernel's
    own f32 entries, the product with V errs by at most max(8, 2·√m)·eps32
    at any m (3·2⁻²² a term from the TF32 split, plus the tensor cores'
    truncating f32 sums). CPU: `gram_matmat_plain`."""
    code = shape_code(family, nu)
    if not xs.is_cuda:
        return gram_matmat_plain(xs, ys, V, kappa, family, nu)
    check_cuda_inputs("gram_matmat", torch.float32, xs, ys, V)
    if V.dim() != 2:
        raise ValueError(f"gram_matmat: V of shape {tuple(V.shape)}, not (m, r)")
    n, m, d = _launch_shapes("gram_matmat", xs, ys, V.shape[0])
    r = V.shape[1]
    xs, ys, V = xs.contiguous(), ys.contiguous(), V.contiguous()
    out = torch.empty((n, r), dtype=torch.float32, device=xs.device)
    if n == 0 or m == 0 or r == 0:
        return out.zero_()
    # V's TF32 (hi, lo) split, transposed into the kernel's tile order, and
    # y's tiles, feature-major, with their squared norms
    tiles = -(-m // MATMAT_TILE_Y)
    split = -(-r // MATMAT_SLAB) * tiles * MATMAT_SLAB * MATMAT_TILE_Y
    vth, vtl = torch.empty((2, split), dtype=torch.float32, device=xs.device)
    yt = torch.empty(tiles * MATMAT_TILE_Y * (d + 1), dtype=torch.float32,
                     device=xs.device)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.stpy_gram_matmat(
            xs.data_ptr(), ys.data_ptr(), V.data_ptr(), out.data_ptr(),
            vth.data_ptr(), vtl.data_ptr(), yt.data_ptr(), n, m, d, r,
            float(kappa), code, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_matmat")
    gram_matmat_scaled.launches += 1
    return out


gram_matmat_scaled.launches = 0


def gram_matvec(x, y, v, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                deriv=False):
    """K(x, y)·v without materialising K; γ scalar or per-dim (ARD).
    `deriv=True` (the k'(sq)·sq shape) raises: ROADMAP Queue 1 item 5."""
    if deriv:
        raise NotImplementedError(f"deriv=True: {_DERIV}")
    g = _as_factor(gamma, x)
    return gram_matvec_scaled(x / g, y / g, v, kappa, family, nu)


def gram_matmat(x, y, V, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                shape="k"):
    """K(x, y)·V for a block of right-hand sides V (m, r), without
    materialising K. Only `shape="k"` is ported."""
    _check_shape(shape)
    g = _as_factor(gamma, x)
    return gram_matmat_scaled(x / g, y / g, V, kappa, family, nu)


def make_lazy_matvec(x, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                     noise=0.0):
    """matvec(v) = (K(x, x) + noise²·I)·v."""
    def matvec(v):
        out = gram_matvec(x, x, v, family=family, gamma=gamma, kappa=kappa,
                          nu=nu)
        return out + (noise * noise) * v.reshape(-1)

    return matvec


def make_lazy_matmat(x, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                     noise=0.0):
    """matmat(V) = (K(x, x) + noise²·I)·V — the block companion of
    `make_lazy_matvec`."""
    def matmat(V):
        out = gram_matmat(x, x, V, family=family, gamma=gamma, kappa=kappa,
                          nu=nu)
        return out + (noise * noise) * V

    return matmat
