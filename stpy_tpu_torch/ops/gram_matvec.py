"""Matrix-free Gram products K(x, y)·v and K(x, y)·V, K never stored.

Port of stpy_tpu/ops/pallas_gram_matvec.py (`gram_matvec` with its custom
VJP `_mv_ad`, `gram_matmat`, `make_lazy_matvec`, `make_lazy_matmat`; its
`make_lazy_matvec_sharded` is in parallel/lazy_kernel.py), in
the three shape functions of its kernels (`_SHAPES`): the kernel "k",
"dk_sq" = k'(sq)·sq (the lengthscale gradient) and "dk" = k'(sq) (ARD and
coordinate cotangents). The 1/γ scaling (scalar or ARD) happens here,
outside the kernels, as in the JAX package. For CUDA tensors
`gram_matvec_scaled` launches csrc/gram_matvec.cu (f32; x's rows in
registers, y streamed through shared memory, the shape on the
special-function unit) and `gram_matmat_scaled` launches
csrc/gram_matmat.cu (f32 only; the product with V on the TF32 tensor cores
in three passes); for CPU tensors they run `gram_matvec_plain` /
`gram_matmat_plain`, the same function in PyTorch (any float dtype), which
materialises K one row chunk at a time.

`gram_matvec` is differentiable in x, y, v, γ and κ through
`torch.autograd.Function` (`_GramMatvec`), whose backward is the JAX
package's: a handful of further matvecs of the derivative shapes, each a
launch of the hand kernel on the card, never a dense K.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch import _build
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops import check_cuda_inputs
from stpy_tpu_torch.ops.gram import (
    _EPS, SHAPES, _as_factor, gram_plain, shape_code,
)

# rows of K that the plain versions materialise at a time
_PLAIN_CHUNK = 4096
# csrc/gram_matmat.cu's tile of V: 128 columns (a slab) by 32 rows of y
MATMAT_SLAB, MATMAT_TILE_Y = 128, 32


def deriv_shape_plain(sq, family="se", nu=1.5, shape="dk_sq"):
    """The derivative shapes of a squared scaled distance sq, as
    stpy_tpu/ops/pallas_gram_matvec.py:_dshape_fn ("dk_sq", k'(sq)·sq) and
    `_pshape_fn` ("dk", k'(sq)), any dtype."""
    if shape not in ("dk_sq", "dk"):
        raise ValueError(f"shape={shape!r}: not a derivative shape")
    shape_code(family, nu, shape)           # raises for a family not fused
    if family == "se":
        e = -0.5 * torch.exp(-0.5 * sq)
        return e * sq if shape == "dk_sq" else e
    r = torch.sqrt(sq + _EPS)
    if nu == 0.5:
        e = -0.5 * torch.exp(-r)
        return e * r if shape == "dk_sq" else e / torch.clamp(r, min=1e-6)
    if nu == 1.5:
        e = -1.5 * torch.exp(-(3.0 ** 0.5) * r)
    else:
        k = (5.0 ** 0.5) * r
        e = -(5.0 / 6.0) * (1.0 + k) * torch.exp(-k)
    return e * sq if shape == "dk_sq" else e


def shape_gram_plain(xs, ys, kappa, family="se", nu=1.5, shape="k"):
    """κ·shape(sq(xs, ys)), (n, m): `gram_plain` for "k", else
    `deriv_shape_plain` of `functions.sq_dist`."""
    if shape == "k":
        return gram_plain(xs, ys, kappa, family, nu)
    K = deriv_shape_plain(F.sq_dist(xs, ys), family, nu, shape)
    return _as_factor(kappa, K) * K


def gram_matmat_plain(xs, ys, V, kappa, family="se", nu=1.5, shape="k"):
    """Plain PyTorch version of the matmat kernel: K(xs, ys)·V through
    `shape_gram_plain`, one (chunk, m) block of K at a time."""
    if xs.shape[0] == 0:
        return shape_gram_plain(xs, ys, kappa, family, nu, shape) @ V
    return torch.cat([shape_gram_plain(xs[r0:r0 + _PLAIN_CHUNK], ys, kappa,
                                       family, nu, shape) @ V
                      for r0 in range(0, xs.shape[0], _PLAIN_CHUNK)])


def gram_matvec_plain(xs, ys, v, kappa, family="se", nu=1.5, shape="k"):
    """Plain PyTorch version of the matvec kernel: `gram_matmat_plain` of
    the one column v."""
    return gram_matmat_plain(xs, ys, v.reshape(-1, 1), kappa, family, nu,
                             shape)[:, 0]


def _count(wrapper, shape):
    """One launch of `wrapper`'s kernel in `shape`: "k" on
    ``wrapper.launches``, a derivative shape on ``wrapper.shape_launches``
    (ops.launch_counts lists them as "<name>[<shape>]")."""
    if shape == "k":
        wrapper.launches += 1
    else:
        wrapper.shape_launches[shape] += 1


def _launch_shapes(name, xs, ys, lead):
    n, d = xs.shape
    if ys.shape[1] != d or lead != ys.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(xs.shape)}, "
                         f"{tuple(ys.shape)} and {lead} rows of the right side")
    if d == 0:
        raise ValueError(f"{name}: coordinates with no feature")
    return n, ys.shape[0], d


def gram_matvec_scaled(xs, ys, v, kappa, family="se", nu=1.5, shape="k"):
    """K(xs, ys)·v, (n,), for coordinates already scaled by 1/γ, K of the
    shape function `shape` (see `SHAPES`). CUDA: the hand kernel, any d; it
    allocates a scratch of about (min(d, 16) + 4)·m floats (y's points
    padded, with their norms and v) and, where it splits the points into
    ranges, one partial sum per range and row. The exponent is base 2 on
    the special-function unit (about 2 ulps) and the diagonal term of
    K(x, x)·v is exact: κ·vᵢ for "k", 0 for "dk_sq", κ·k'(0)·vᵢ for "dk".
    CPU: `gram_matvec_plain`."""
    code = shape_code(family, nu, shape)
    v = v.reshape(-1)
    if not xs.is_cuda:
        return gram_matvec_plain(xs, ys, v, kappa, family, nu, shape)
    check_cuda_inputs("gram_matvec", torch.float32, xs, ys, v)
    n, m, d = _launch_shapes("gram_matvec", xs, ys, v.shape[0])
    xs, ys, v = xs.contiguous(), ys.contiguous(), v.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=xs.device)
    if n == 0 or m == 0:
        return out.zero_()
    lib = _build.library()
    with torch.cuda.device(xs.device):
        floats = lib.stpy_gram_matvec_scratch(n, m, d)
        if floats < 0:
            raise RuntimeError("gram_matvec: the device's SM count could not "
                               "be read")
        scratch = torch.empty(floats, dtype=torch.float32, device=xs.device)
        err = lib.stpy_gram_matvec(
            xs.data_ptr(), ys.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n, m, d, float(kappa), code,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "gram_matvec")
    _count(gram_matvec_scaled, shape)
    return out


gram_matvec_scaled.launches = 0
gram_matvec_scaled.shape_launches = dict.fromkeys(SHAPES[1:], 0)


def gram_matmat_scaled(xs, ys, V, kappa, family="se", nu=1.5, shape="k"):
    """K(xs, ys)·V, (n, r), for coordinates already scaled by 1/γ, K of the
    shape function `shape` (see `SHAPES`). CUDA: the
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
    truncating f32 sums); in the derivative shapes these bars hold over
    Σⱼ|Kᵢⱼ||Vⱼc| as well. A block computes the entries of one 128-column
    slab of V, so each column slab past the first computes them again.
    CPU: `gram_matmat_plain`."""
    code = shape_code(family, nu, shape)
    if not xs.is_cuda:
        return gram_matmat_plain(xs, ys, V, kappa, family, nu, shape)
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
    _count(gram_matmat_scaled, shape)
    return out


gram_matmat_scaled.launches = 0
gram_matmat_scaled.shape_launches = dict.fromkeys(SHAPES[1:], 0)


class _GramMatvec(torch.autograd.Function):
    """K(x, y)·v with the backward of stpy_tpu/ops/pallas_gram_matvec.py:
    `_mv_ad` (`_mv_ad_bwd`), x̃ = x/γ, ỹ = y/γ, W_s(a, b)w = κ·s(sq(a, b))·w:
      v̄ = W_k(ỹ, x̃)ḡ;  κ̄ = ḡᵀ(Kv)/κ;
      γ̄ = (−2/γ)·ḡᵀW_dk_sq(x̃, ỹ)v for a scalar γ; per dimension c of an
        ARD γ, (−2/γ_c)·ḡᵀ[x̃_c²∘W_dk v − 2x̃_c∘W_dk(v∘ỹ_c) + W_dk(v∘ỹ_c²)];
      x̄_c = 2ḡ∘(x̃_c∘W_dk(x̃, ỹ)v − W_dk(x̃, ỹ)(v∘ỹ_c))/γ_c and
      ȳ_c = 2v∘(ỹ_c∘W_dk(ỹ, x̃)ḡ − W_dk(ỹ, x̃)(ḡ∘x̃_c))/γ_c.
    Every product is one `gram_matvec_scaled` call on detached tensors (a
    launch of csrc/gram_matvec.cu on the card). Only the products of the
    inputs that need a gradient run: the same function with fewer
    launches than the JAX package's, which forms them all."""

    @staticmethod
    def forward(ctx, x, y, v, gamma, kappa, family, nu):
        if isinstance(gamma, torch.Tensor):
            gamma = gamma.detach()
        g = _as_factor(gamma, x)
        xs, ys = x.detach() / g, y.detach() / g
        v = v.detach().reshape(-1)
        out = gram_matvec_scaled(xs, ys, v, float(kappa), family, nu)
        ctx.save_for_backward(xs, ys, v, out)
        ctx.gamma, ctx.kappa, ctx.family, ctx.nu = g, float(kappa), family, nu
        return out

    @staticmethod
    def backward(ctx, gbar):
        xs, ys, v, out = ctx.saved_tensors
        g, kappa, family, nu = ctx.gamma, ctx.kappa, ctx.family, ctx.nu
        need_x, need_y, need_v, need_g, need_k = ctx.needs_input_grad[:5]
        gbar = gbar.detach().reshape(-1)

        def W(a, b, w, shape):
            return gram_matvec_scaled(a, b, w, kappa, family, nu, shape)

        ard = isinstance(g, torch.Tensor) and g.dim() > 0
        grads = [None] * 7
        if need_v:
            grads[2] = W(ys, xs, gbar, "k")
        if need_k:
            grads[4] = (gbar @ out) / kappa
        Wv = W(xs, ys, v, "dk") if need_x or (need_g and ard) else None
        Wy = ({c: W(xs, ys, v * ys[:, c], "dk") for c in range(xs.shape[1])}
              if need_x or (need_g and ard) else None)
        if need_g:
            if not ard:
                grads[3] = (-2.0 / g) * (gbar @ W(xs, ys, v, "dk_sq"))
            else:
                parts = []
                for c in range(xs.shape[1]):
                    t1 = gbar @ (xs[:, c] ** 2 * Wv)
                    t2 = gbar @ (xs[:, c] * Wy[c])
                    t3 = gbar @ W(xs, ys, v * ys[:, c] ** 2, "dk")
                    parts.append((-2.0 / g[c]) * (t1 - 2.0 * t2 + t3))
                grads[3] = torch.stack(parts)
        if need_x:
            cols = [2.0 * gbar * (xs[:, c] * Wv - Wy[c])
                    for c in range(xs.shape[1])]
            grads[0] = torch.stack(cols, dim=1) / g
        if need_y:
            Wg = W(ys, xs, gbar, "dk")
            cols = [2.0 * v * (ys[:, c] * Wg - W(ys, xs, gbar * xs[:, c], "dk"))
                    for c in range(xs.shape[1])]
            grads[1] = torch.stack(cols, dim=1) / g
        return tuple(grads)


def gram_matvec(x, y, v, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                deriv=False):
    """K(x, y)·v without materialising K; γ scalar or per-dim (ARD).

    Differentiable in x, y, v, γ and κ (whichever are tensors that require
    grad): the backward is a handful of further matrix-free products
    (`_GramMatvec`), never a dense K. `deriv=True` applies k'(sq)·sq
    instead of k(sq) (the "dk_sq" shape; primal only)."""
    if deriv:
        g = _as_factor(gamma, x)
        return gram_matvec_scaled(x / g, y / g, v, kappa, family, nu, "dk_sq")
    return _GramMatvec.apply(x, y, v.reshape(-1), gamma, kappa, family, nu)


def gram_matmat(x, y, V, *, family="se", gamma=1.0, kappa=1.0, nu=1.5,
                shape="k"):
    """K(x, y)·V for a block of right-hand sides V (m, r), without
    materialising K, in the shape function `shape` (primal only; use
    `gram_matvec` column by column for gradients)."""
    g = _as_factor(gamma, x)
    return gram_matmat_scaled(x / g, y / g, V, kappa, family, nu, shape)


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

