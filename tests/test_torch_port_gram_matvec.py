"""Port parity: the matrix-free Gram products of stpy_tpu_torch
(ops/gram_matvec.py) against stpy_tpu/ops/pallas_gram_matvec.py, in the
three shape functions of its kernels ("k", "dk_sq", "dk"), the custom VJP
of `gram_matvec`, plus the port's import isolation.

Inputs come from numpy with fixed seeds. On the CPU the port's wrappers run
their plain PyTorch versions. Tolerances:
* plain versions in float64 against the JAX package's jnp path in x64:
  1e-10 relative to the largest entry (both sum the same K·v in f64, in
  other orders); gradients of `gram_matvec` against `jax.grad` through
  `_mv_ad`: 1e-10 relative to the largest entry of each, the same
  products in other orders;
* the plain version in f32 against the Pallas kernel body run in interpret
  mode: 1e-4 absolute, the bound tests/test_parallel.py holds that body to
  against a dense f64 product, in every shape.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stpy_tpu.ops import pallas_gram_matvec as jax_mv
from stpy_tpu_torch.ops import gram_matvec as port_mv
from stpy_tpu_torch.ops import kernel_wrappers, launch_counts
from stpy_tpu_torch.ops.gram import SHAPE_CODES, gram_plain, shape_code
from stpy_tpu_torch.ops.gram import SHAPES as SHAPES_OF_KERNELS
from stpy_tpu_torch.ops.gram_matvec import (
    deriv_shape_plain,
    gram_matmat,
    gram_matmat_scaled,
    gram_matvec,
    gram_matvec_scaled,
    make_lazy_matmat,
    make_lazy_matvec,
)

from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10
PALLAS_ATOL = 1e-4
REPO = Path(__file__).resolve().parent.parent

# (family, nu, gamma): every fused shape, scalar and per-dimension (ARD) γ
FAMILIES = [
    ("se", 1.0, 0.7),
    ("matern", 0.5, 0.9),
    ("matern", 1.5, 1.1),
    ("matern", 2.5, 0.6),
    ("se", 1.0, [0.5, 0.8, 1.1]),
    ("matern", 1.5, [1.2, 0.7, 0.9]),
]
IDS = ["se", "matern12", "matern32", "matern52", "ard_se", "ard_matern32"]
# ragged n, m, r: no multiple of any tile of either package
SHAPES = [(37, 53, 5), (130, 61, 3)]
# the kernels' shape functions: k, k'(sq)·sq and k'(sq)
KINDS = list(SHAPES_OF_KERNELS)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def operands(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)), rng.uniform(-1, 1, (m, 3)),
            rng.standard_normal(m), rng.standard_normal((m, r)))


def torch_gamma(gamma):
    return torch.as_tensor(np.asarray(gamma), dtype=torch.float64)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_gram_matvec_matches_jax(family, nu, gamma, shape, kind):
    x, y, v, _ = operands(*shape)
    xj, yj, vj, gj = (jnp.asarray(a) for a in (x, y, v, gamma))
    xt, yt, vt, gt = (torch.as_tensor(np.asarray(a)) for a in (x, y, v, gamma))
    if kind == "k":
        want = jax_mv.gram_matvec(xj, yj, vj, family=family, gamma=gj,
                                  kappa=1.3, nu=nu)
        got = gram_matvec(xt, yt, vt, family=family, gamma=gt, kappa=1.3,
                          nu=nu)
    else:
        want = jax_mv._mv_scaled(xj / gj, yj / gj, vj, 1.3, family, nu,
                                 shape=kind)
        got = gram_matvec_scaled(xt / gt, yt / gt, vt, 1.3, family, nu, kind)
    if kind == "dk_sq":
        # the public form of the lengthscale-gradient product
        public = jax_mv.gram_matvec(xj, yj, vj, family=family, gamma=gj,
                                    kappa=1.3, nu=nu, deriv=True)
        assert rel_err(public, want) <= RTOL
        assert torch.equal(gram_matvec(xt, yt, vt, family=family, gamma=gt,
                                       kappa=1.3, nu=nu, deriv=True), got)
    assert got.shape == (shape[0],) and got.dtype == torch.float64
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_gram_matmat_matches_jax(family, nu, gamma, shape, kind):
    x, y, _, V = operands(*shape)
    want = jax_mv.gram_matmat(jnp.asarray(x), jnp.asarray(y), jnp.asarray(V),
                              family=family, gamma=jnp.asarray(gamma),
                              kappa=0.8, nu=nu, shape=kind)
    got = gram_matmat(torch.as_tensor(x), torch.as_tensor(y),
                      torch.as_tensor(V), family=family,
                      gamma=torch_gamma(gamma), kappa=0.8, nu=nu, shape=kind)
    assert got.shape == (shape[0], shape[2])
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("family,nu", [("se", 1.0), ("matern", 1.5)])
def test_lazy_operators_match_jax(family, nu):
    x, _, v, V = operands(45, 45, 4, seed=3)
    kw = dict(family=family, gamma=0.6, kappa=1.1, nu=nu, noise=0.3)
    jmv = jax_mv.make_lazy_matvec(jnp.asarray(x), **kw)
    jmm = jax_mv.make_lazy_matmat(jnp.asarray(x), **kw)
    tmv = make_lazy_matvec(torch.as_tensor(x), **kw)
    tmm = make_lazy_matmat(torch.as_tensor(x), **kw)
    assert rel_err(tmv(torch.as_tensor(v)).numpy(), jmv(jnp.asarray(v))) <= RTOL
    assert rel_err(tmm(torch.as_tensor(V)).numpy(), jmm(jnp.asarray(V))) <= RTOL


def _pallas_operands(n, m, r, family, gamma):
    x, y, v, V = operands(n, m, r, seed=5)
    xs, ys = (a / np.asarray(gamma) for a in (x, y))
    return [a.astype(np.float32) for a in (xs, ys, v, V)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_f32_matvec_matches_the_jax_pallas_kernel_in_interpret_mode(
        family, nu, gamma, kind):
    xs, ys, v, _ = _pallas_operands(21, 150, 1, family, gamma)
    want = jax_mv._gram_matvec_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(v), 1.3, family=family,
        nu=float(nu), block_m=8, block_n=128, interpret=True, shape=kind)
    got = gram_matvec_scaled(torch.as_tensor(xs), torch.as_tensor(ys),
                             torch.as_tensor(v), 1.3, family, nu, kind)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= PALLAS_ATOL


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES[:4], ids=IDS[:4])
def test_f32_matmat_matches_the_jax_pallas_kernel_in_interpret_mode(
        family, nu, gamma, kind):
    xs, ys, _, V = _pallas_operands(21, 150, 5, family, gamma)
    want = jax_mv._gram_matmat_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(V), 0.8, family=family,
        nu=float(nu), block_m=8, block_n=128, interpret=True, shape=kind)
    got = gram_matmat_scaled(torch.as_tensor(xs), torch.as_tensor(ys),
                             torch.as_tensor(V), 0.8, family, nu, kind)
    assert got.shape == (21, 5) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= PALLAS_ATOL


def test_plain_versions_chunk_rows_without_changing_the_product():
    # more rows than one plain chunk (4096): the row blocks join in order
    x, y, v, V = operands(4100, 7, 2, seed=9)
    xs, ys = torch.as_tensor(x), torch.as_tensor(y)
    Vt = torch.as_tensor(V)
    dense = torch.exp(-0.5 * torch.cdist(xs, ys) ** 2)
    assert torch.allclose(gram_matmat_scaled(xs, ys, Vt, 1.0), dense @ Vt,
                          rtol=0, atol=1e-12)
    assert torch.allclose(gram_matvec_scaled(xs, ys, Vt[:, 0], 1.0),
                          dense @ Vt[:, 0], rtol=0, atol=1e-12)


def tf32_rna(a):
    """float32 → TF32 (10 mantissa bits), round to nearest with ties away
    from zero, as `cvt.rna.tf32.f32`: the low 13 bits rounded off."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("n,m,d,r", [(300, 517, 3, 77), (2048, 4096, 8, 128)],
                         ids=["ragged", "2048x4096"])
@pytest.mark.parametrize("family,nu,gamma", [("se", 1.5, 0.5),
                                             ("matern", 1.5, 0.8)],
                         ids=["se", "matern32"])
def test_three_tf32_passes_hold_the_card_kernels_f32_bar(family, nu, gamma, n,
                                                         m, d, r):
    """csrc/gram_matmat.cu's arithmetic, emulated: the f32 Gram entries and
    V split into TF32 hi + lo, the product Kh·Vh + Kh·Vl + Kl·Vh summed in
    f32. Held, as chip_smoke.py holds the kernel, to 2·√m·eps32 of
    Σⱼ|Kᵢⱼ||Vⱼc| against the product in float64 on the same f32 inputs. One
    pass, Kh·Vh, misses that bar: the record of why the kernel makes three."""
    rng = np.random.default_rng(11)
    xs = (rng.uniform(-1, 1, (n, d)) / gamma).astype(np.float32)
    ys = (rng.uniform(-1, 1, (m, d)) / gamma).astype(np.float32)
    V = rng.standard_normal((m, r)).astype(np.float32)
    K = gram_plain(torch.as_tensor(xs), torch.as_tensor(ys), 1.0, family,
                   nu).numpy()
    Kh, Vh = tf32_rna(K), tf32_rna(V)
    Kl, Vl = tf32_rna(K - Kh), tf32_rna(V - Vh)
    f32 = [torch.as_tensor(a) for a in (Kh, Kl, Vh, Vl)]
    three = (f32[0] @ f32[2] + f32[0] @ f32[3] + f32[1] @ f32[2]).double()
    one = (f32[0] @ f32[2]).double()
    V64 = torch.as_tensor(V, dtype=torch.float64)
    both = gram_matmat_scaled(torch.as_tensor(xs, dtype=torch.float64),
                              torch.as_tensor(ys, dtype=torch.float64),
                              torch.cat([V64, V64.abs()], dim=1), 1.0, family,
                              nu)
    ref, scale = both[:, :r], both[:, r:]
    bar = 2.0 * np.sqrt(m) * 2.0 ** -23
    assert float(((three - ref).abs() / scale).max()) <= bar
    assert float(((one - ref).abs() / scale).max()) > bar


@pytest.mark.parametrize("m", [1, 3, 16])
@pytest.mark.parametrize("family,nu,gamma", [("se", 1.5, 0.5),
                                             ("matern", 1.5, 0.8)],
                         ids=["se", "matern32"])
def test_three_tf32_passes_hold_the_product_bar_at_few_points(family, nu,
                                                              gamma, m):
    """At a handful of y points (an IterativeGP on a few training points
    sends m = n) the f32 entries' own rounding can exceed 2·√m·eps32, so
    there the kernel's product is held, as chip_smoke.py holds it, against
    the float64 product of the same f32 entries: emulated, the three TF32
    passes err by at most 8·eps32 of Σⱼ|Kᵢⱼ||Vⱼc| (3·2⁻²² a term)."""
    rng = np.random.default_rng(12)
    xs = (rng.uniform(-1, 1, (64, 8)) / gamma).astype(np.float32)
    ys = (rng.uniform(-1, 1, (m, 8)) / gamma).astype(np.float32)
    V = rng.standard_normal((m, 7)).astype(np.float32)
    K = gram_plain(torch.as_tensor(xs), torch.as_tensor(ys), 1.0, family,
                   nu).numpy()
    Kh, Vh = tf32_rna(K), tf32_rna(V)
    Kl, Vl = tf32_rna(K - Kh), tf32_rna(V - Vh)
    f32 = [torch.as_tensor(a) for a in (Kh, Kl, Vh, Vl)]
    three = (f32[0] @ f32[2] + f32[0] @ f32[3] + f32[1] @ f32[2]).double()
    K64, V64 = (torch.as_tensor(a, dtype=torch.float64) for a in (K, V))
    ref, scale = K64 @ V64, K64 @ V64.abs()
    assert float(((three - ref).abs() / scale).max()) <= 8 * 2.0 ** -23


@pytest.mark.parametrize("family,nu", [("se", 1.0), ("matern", 1.5)])
def test_gram_matmat_matches_jax_past_the_features_the_kernel_stages(family,
                                                                     nu):
    """d = 400: more features than csrc/gram_matmat.cu stages in shared
    memory (384; it reads the rest from global memory). The contract takes
    any d."""
    rng = np.random.default_rng(13)
    x, y = rng.uniform(-1, 1, (37, 400)), rng.uniform(-1, 1, (53, 400))
    V = rng.standard_normal((53, 5))
    kw = dict(family=family, gamma=9.0, kappa=0.8, nu=nu)
    want = jax_mv.gram_matmat(jnp.asarray(x), jnp.asarray(y), jnp.asarray(V),
                              **kw)
    got = gram_matmat(torch.as_tensor(x), torch.as_tensor(y),
                      torch.as_tensor(V), **kw)
    assert got.shape == (37, 5)
    assert rel_err(got.numpy(), want) <= RTOL


LOG2E = np.float32(1.4426950408889634)
# (family, nu, γ): the four shapes of csrc/gram_matvec.cu at the lazy tiers'
# scales; ragged (n, m, d): fewer features than the kernel holds in
# registers (8), 8, more (16) and past them (read from global memory)
EMULATED = [("se", 1.5, 0.5), ("matern", 0.5, 0.8), ("matern", 1.5, 0.8),
            ("matern", 2.5, 0.8)]
EMULATED_SHAPES = [(37, 53, 3), (130, 300, 8), (61, 517, 11), (45, 200, 20)]


def _fma32(a, b, c):
    """fmaf in numpy: the product of two f32 values is exact in float64, so
    the sum rounds once there and once more to f32 (the double rounding
    differs from one fused rounding by at most 1 ulp, and rarely)."""
    return (np.float64(a) * b + c).astype(np.float32)


def _ulps_up(a, k):
    for _ in range(k):
        a = np.nextafter(a, np.float32(np.inf), dtype=np.float32)
    return a


def _ex2(a):
    """ex2.approx.ftz.f32 modelled 2 ulps above 2**a, exact at a = 0."""
    e = np.exp2(np.float64(a)).astype(np.float32)
    return np.where(a == 0, np.float32(1), _ulps_up(e, 2))


def _sqrt(a):
    """sqrt.approx.ftz.f32 modelled 1 ulp above √a, exact at a = 0."""
    r = np.sqrt(np.float64(a)).astype(np.float32)
    return np.where(a == 0, np.float32(0), _ulps_up(r, 1))


def emulate_gram_matvec(xs, ys, v, kappa, family, nu, kind="k"):
    """csrc/gram_matvec.cu's arithmetic in f32: the norms and dots by one
    fmaf chain over ascending features, sq = max(|x|² + |y|² − 2x·y, 0),
    gram_shape.cuh's shape_exp2 (the constant folded into an f32 exponent
    of base 2) in the shape function `kind`, each term fmaf'd into its
    row's sum in ascending j (one range: the longest f32 chain the kernel
    runs). Returns (out, sq, K)."""
    f32 = np.float32
    nx = np.zeros(xs.shape[0], f32)
    ny = np.zeros(ys.shape[0], f32)
    dot = np.zeros((xs.shape[0], ys.shape[0]), f32)
    for k in range(xs.shape[1]):
        nx = _fma32(xs[:, k], xs[:, k], nx)
        ny = _fma32(ys[:, k], ys[:, k], ny)
        dot = _fma32(xs[:, k, None], ys[None, :, k], dot)
    t = (nx[:, None] + ny[None, :]).astype(f32)
    sq = np.maximum((np.float64(t) - 2.0 * np.float64(dot)).astype(f32), f32(0))
    if family == "se":
        K = _ex2((f32(-0.5) * LOG2E * sq).astype(f32))
        if kind == "dk_sq":
            K = ((f32(-0.5) * sq).astype(f32) * K).astype(f32)
        elif kind == "dk":
            K = (f32(-0.5) * K).astype(f32)
    else:
        r = _sqrt(sq)
        c = {0.5: f32(1), 1.5: f32(1.7320508075688772),
             2.5: f32(2.23606797749979)}[nu]
        e = _ex2(((-c * LOG2E).astype(f32) * r).astype(f32))
        k = (c * r).astype(f32)
        if kind == "k" and nu == 0.5:
            K = e
        elif kind == "k" and nu == 1.5:
            K = _fma32(k, e, e)
        elif kind == "k":
            poly = _fma32(_fma32(k, f32(1.0 / 3.0), f32(1)), k, f32(1))
            K = (poly * e).astype(f32)
        elif nu == 0.5 and kind == "dk_sq":
            K = ((f32(-0.5) * r).astype(f32) * e).astype(f32)
        elif nu == 0.5:
            K = ((f32(-0.5) * e).astype(f32) / np.maximum(r, f32(1e-6))).astype(f32)
        elif nu == 1.5:
            K = (f32(-1.5) * (sq if kind == "dk_sq" else f32(1))).astype(f32)
            K = (K * e).astype(f32)
        else:
            K = ((f32(-5.0 / 6.0) * _fma32(c, r, f32(1))).astype(f32) * e).astype(f32)
            if kind == "dk_sq":
                K = (K * sq).astype(f32)
    acc = np.zeros(xs.shape[0], f32)
    for j in range(ys.shape[0]):
        acc = _fma32(K[:, j], v[j], acc)
    return (f32(kappa) * acc).astype(f32), sq, K


# k'(0) of each family: the "dk" entry of a point against itself (Matérn-½
# through the clamp max(r, 1e-6) of _pshape_fn)
DK_AT_0 = {("se", 1.5): -0.5, ("matern", 0.5): -0.5 / np.float32(1e-6),
           ("matern", 1.5): -1.5, ("matern", 2.5): -5.0 / 6.0}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,m,d", EMULATED_SHAPES,
                         ids=[f"{n}x{m}_d{d}" for n, m, d in EMULATED_SHAPES])
@pytest.mark.parametrize("family,nu,gamma", EMULATED,
                         ids=["se", "matern12", "matern32", "matern52"])
def test_base2_shapes_hold_the_card_kernels_f32_bar(family, nu, gamma, n, m,
                                                     d, kind):
    """csrc/gram_matvec.cu's arithmetic, emulated (`emulate_gram_matvec`,
    MUFU.EX2 2 ulps off, MUFU.SQRT 1): held, as chip_smoke.py holds the
    kernel, to 2·√m·eps32 of Σⱼ|Kᵢⱼ||vⱼ| against the JAX package's float64
    matvec in the same shape function on the same f32 inputs. Where y_j is
    a copy of x_i, sq is exactly 0 and the entry exact: 1 for "k" (so
    K(x, x)'s diagonal is exactly κ), 0 for "dk_sq" and k'(0) for "dk"."""
    rng = np.random.default_rng(14)
    spread = np.sqrt(8.0 / d) if d > 8 else 1.0
    xs = (rng.uniform(-1, 1, (n, d)) * spread / gamma).astype(np.float32)
    ys = (rng.uniform(-1, 1, (m, d)) * spread / gamma).astype(np.float32)
    ys[::7][:n] = xs[:len(ys[::7])]          # every 7th point a copy of an x
    v = rng.standard_normal(m).astype(np.float32)
    got, sq, K = emulate_gram_matvec(xs, ys, v, 1.3, family, nu, kind)
    x64, y64 = jnp.asarray(xs, jnp.float64), jnp.asarray(ys, jnp.float64)
    ref = np.asarray(jax_mv._mv_scaled(x64, y64, jnp.asarray(v, jnp.float64),
                                       1.3, family, nu, shape=kind))
    scale = np.abs(np.asarray(jax_mv._mv_scaled(
        x64, y64, jnp.asarray(np.abs(v), jnp.float64), 1.3, family, nu,
        shape=kind)))
    bar = 2.0 * np.sqrt(m) * 2.0 ** -23
    assert float(np.max(np.abs(np.float64(got) - ref) / scale)) <= bar
    copies = np.arange(0, m, 7)[:n]
    rows = np.arange(len(copies))
    diag = {"k": 1.0, "dk_sq": 0.0}.get(kind, DK_AT_0[(family, nu)])
    assert np.all(sq[rows, copies] == 0)
    assert np.all(K[rows, copies] == np.float32(diag))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that claims to live on the card: it reaches the CUDA
    branch of a wrapper, whose input checks run before any kernel is built."""

    @property
    def is_cuda(self):
        return True


def _fake_cuda(a, requires_grad=False):
    t = torch.as_tensor(a, dtype=torch.float32).requires_grad_(requires_grad)
    return t.as_subclass(_FakeCuda)


@pytest.mark.parametrize("wrapper", [gram_matvec_scaled, gram_matmat_scaled])
def test_cuda_wrappers_raise_on_requires_grad(wrapper):
    x, y, v, V = operands(6, 5, 2)
    rhs = v if wrapper is gram_matvec_scaled else V
    with pytest.raises(RuntimeError, match="no backward yet"):
        wrapper(_fake_cuda(x), _fake_cuda(y), _fake_cuda(rhs, True), 1.0)


@pytest.mark.parametrize("wrapper", [gram_matvec_scaled, gram_matmat_scaled])
def test_cuda_wrappers_take_f32_only(wrapper):
    x, y, v, V = operands(6, 5, 2)
    rhs = v if wrapper is gram_matvec_scaled else V
    x64 = torch.as_tensor(x).as_subclass(_FakeCuda)
    with pytest.raises(TypeError, match="float32"):
        wrapper(x64, _fake_cuda(y), _fake_cuda(rhs), 1.0)


def test_derivative_shapes_raise_naming_the_roadmap():
    """The derivative shapes exist for the fused families (held to the JAX
    package above); for a general ν they raise, as the shape "k" does and
    as the JAX package's matrix-free products do."""
    x, y, v, V = (torch.as_tensor(a) for a in operands(6, 5, 2))
    for kind in ("dk", "dk_sq"):
        with pytest.raises(NotImplementedError, match="have a fused kernel"):
            gram_matmat(x, y, V, family="matern", nu=3.5, shape=kind)
        with pytest.raises(NotImplementedError, match="have a fused kernel"):
            gram_matvec_scaled(x, y, v, 1.0, "matern", 3.5, kind)
    with pytest.raises(NotImplementedError, match="have a fused kernel"):
        gram_matvec(x, y, v, family="matern", nu=3.5, deriv=True)
    with pytest.raises(ValueError, match="not one of"):
        gram_matmat(x, y, V, shape="d2k")
    want = jax_mv.gram_matvec(*(jnp.asarray(np.asarray(a)) for a in (x, y, v)),
                              gamma=0.7, deriv=True)
    assert rel_err(gram_matvec(x, y, v, gamma=0.7, deriv=True).numpy(),
                   want) <= RTOL


def test_shape_codes_are_one_code_space_with_the_kernels_switch():
    """ops/gram.py's codes are the CUDA sources': code = family + 4·kind,
    12 codes (gram_shape.cuh's SHAPE_COUNT, the bound both products'
    entry points check); decoding a code as the kernels do gives the JAX
    package's shape function, checked on a grid of sq from 0."""
    header = (REPO / "stpy_tpu_torch/csrc/gram_shape.cuh").read_text()
    assert "constexpr int SHAPE_KINDS = 3;" in header
    assert "constexpr int SHAPE_COUNT = 4 * SHAPE_KINDS;" in header
    assert "FAMILY = SHAPE % 4, KIND = SHAPE / 4" in header
    for src in ("gram_matvec.cu", "gram_matmat.cu"):
        text = (REPO / "stpy_tpu_torch/csrc" / src).read_text()
        assert "shape >= SHAPE_COUNT" in text, src
    family_of = {code: key for key, code in SHAPE_CODES.items()}
    sq = jnp.asarray(np.concatenate([[0.0], np.geomspace(1e-12, 50.0, 40)]))
    codes = set()
    for (family, nu), base in SHAPE_CODES.items():
        nu = 1.5 if nu is None else nu
        for kind in KINDS:
            code = shape_code(family, nu, kind)
            codes.add(code)
            fam_d, nu_d = family_of[code % 4]
            kind_d = KINDS[code // 4]
            assert (fam_d, kind_d) == (family, kind) and code % 4 == base
            want = jax_mv._SHAPES[kind](family, nu)(sq)
            sq_t = torch.as_tensor(np.array(sq))
            # "k" through the Gram's plain version at distances √sq from 0
            got = (deriv_shape_plain(sq_t, fam_d, nu, kind_d) if kind != "k"
                   else gram_plain(torch.sqrt(sq_t)[:, None],
                                   torch.zeros(1, 1, dtype=torch.float64),
                                   1.0, fam_d, nu)[:, 0])
            assert rel_err(got.numpy(), want) <= RTOL, (family, nu, kind)
    assert codes == set(range(12))


@pytest.mark.parametrize("family,nu,gamma", [
    ("se", 1.0, 0.7), ("matern", 1.5, 1.1), ("matern", 0.5, 0.9),
    ("se", 1.0, [0.5, 0.8, 1.1]), ("matern", 2.5, [1.2, 0.7, 0.9])],
    ids=["se", "matern32", "matern12", "ard_se", "ard_matern52"])
def test_gram_matvec_gradients_match_jax_grad_of_mv_ad(family, nu, gamma):
    """torch.autograd through `_GramMatvec` against jax.grad through the
    JAX package's custom VJP `_mv_ad`, float64: the cotangents of x, y, v,
    γ (scalar or ARD) and κ of the loss wᵀK(x, y)v."""
    x, y, v, _ = operands(37, 53, 1, seed=21)
    w = np.random.default_rng(22).standard_normal(37)

    def jloss(x, y, v, g, k):
        return jnp.asarray(w) @ jax_mv.gram_matvec(x, y, v, family=family,
                                                   gamma=g, kappa=k, nu=nu)

    args = (x, y, v, np.asarray(gamma, np.float64), 1.3)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.as_tensor(np.asarray(a, np.float64)).requires_grad_()
          for a in args]
    loss = torch.as_tensor(w) @ gram_matvec(ts[0], ts[1], ts[2],
                                            family=family, gamma=ts[3],
                                            kappa=ts[4], nu=nu)
    loss.backward()
    for t, wj in zip(ts, want):
        assert t.grad.shape == t.shape
        assert rel_err(t.grad.numpy(), wj) <= RTOL


def test_gradient_products_launch_the_kernel_on_detached_tensors(monkeypatch):
    """`_GramMatvec` hands `gram_matvec_scaled` (the kernel's wrapper, whose
    CUDA branch refuses tensors that require grad) detached tensors only,
    in the shapes of `_mv_ad`'s backward: scalar γ one "dk_sq" product,
    ARD γ and x̄ share 1 + d "dk" products and ȳ adds 1 + d more."""
    calls = []
    real = port_mv.gram_matvec_scaled

    def recording(xs, ys, v, kappa, family="se", nu=1.5, shape="k"):
        for t in (xs, ys, v, kappa):
            assert not (isinstance(t, torch.Tensor) and t.requires_grad)
        calls.append(shape)
        return real(xs, ys, v, kappa, family, nu, shape)

    monkeypatch.setattr(port_mv, "gram_matvec_scaled", recording)
    x, y, v, _ = (torch.as_tensor(a) for a in operands(9, 7, 1, seed=23))
    for gamma, want in ((0.8, {"k": 2, "dk_sq": 1, "dk": 8}),
                        ([0.5, 0.8, 1.1], {"k": 2, "dk": 11})):
        calls.clear()
        ts = [t.clone().requires_grad_() for t in (x, y, v)]
        g = torch.as_tensor(np.asarray(gamma)).requires_grad_()
        k = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
        gram_matvec(*ts, gamma=g, kappa=k).sum().backward()
        assert {s: calls.count(s) for s in set(calls)} == want
        assert all(t.grad is not None for t in (*ts, g, k))


def test_cpu_products_launch_nothing_and_both_kernels_are_registered():
    assert {"gram_matvec", "gram_matmat"} <= set(kernel_wrappers())
    # each derivative shape of both products is counted apart
    assert {f"{name}[{kind}]" for name in ("gram_matvec", "gram_matmat")
            for kind in ("dk_sq", "dk")} <= set(launch_counts())
    before = launch_counts()
    x, y, v, V = (torch.as_tensor(a) for a in operands(6, 5, 2))
    for kind in KINDS:
        gram_matvec_scaled(x, y, v, 1.0, shape=kind)
        gram_matmat(x, y, V, shape=kind)
    xg = x.clone().requires_grad_()
    gram_matvec(xg, y, v).sum().backward()
    assert launch_counts() == before


def test_importing_every_port_module_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "stpy_tpu_torch").rglob("*.py"))
    assert "stpy_tpu_torch.parallel.iterative" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'stpy_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
