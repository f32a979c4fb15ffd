"""Port parity: the matrix-free Gram products of stpy_tpu_torch
(ops/gram_matvec.py) against stpy_tpu/ops/pallas_gram_matvec.py, plus the
port's import isolation.

Inputs come from numpy with fixed seeds. On the CPU the port's wrappers run
their plain PyTorch versions. Tolerances:
* plain versions in float64 against the JAX package's jnp path in x64:
  1e-10 relative to the largest entry (both sum the same K·v in f64, in
  other orders);
* the plain version in f32 against the Pallas kernel body run in interpret
  mode: 1e-4 absolute, the bound tests/test_parallel.py holds that body to
  against a dense f64 product.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.ops import pallas_gram_matvec as jax_mv
from stpy_tpu_torch.ops import kernel_wrappers, launch_counts
from stpy_tpu_torch.ops.gram_matvec import (
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


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def operands(n, m, r, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)), rng.uniform(-1, 1, (m, 3)),
            rng.standard_normal(m), rng.standard_normal((m, r)))


def torch_gamma(gamma):
    return torch.as_tensor(np.asarray(gamma), dtype=torch.float64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_gram_matvec_matches_jax(family, nu, gamma, shape):
    x, y, v, _ = operands(*shape)
    want = jax_mv.gram_matvec(jnp.asarray(x), jnp.asarray(y), jnp.asarray(v),
                              family=family, gamma=jnp.asarray(gamma),
                              kappa=1.3, nu=nu)
    got = gram_matvec(torch.as_tensor(x), torch.as_tensor(y),
                      torch.as_tensor(v), family=family,
                      gamma=torch_gamma(gamma), kappa=1.3, nu=nu)
    assert got.shape == (shape[0],) and got.dtype == torch.float64
    assert rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_gram_matmat_matches_jax(family, nu, gamma, shape):
    x, y, _, V = operands(*shape)
    want = jax_mv.gram_matmat(jnp.asarray(x), jnp.asarray(y), jnp.asarray(V),
                              family=family, gamma=jnp.asarray(gamma),
                              kappa=0.8, nu=nu)
    got = gram_matmat(torch.as_tensor(x), torch.as_tensor(y),
                      torch.as_tensor(V), family=family,
                      gamma=torch_gamma(gamma), kappa=0.8, nu=nu)
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


@pytest.mark.parametrize("family,nu,gamma", FAMILIES, ids=IDS)
def test_f32_matvec_matches_the_jax_pallas_kernel_in_interpret_mode(
        family, nu, gamma):
    xs, ys, v, _ = _pallas_operands(21, 150, 1, family, gamma)
    want = jax_mv._gram_matvec_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(v), 1.3, family=family,
        nu=float(nu), block_m=8, block_n=128, interpret=True)
    got = gram_matvec_scaled(torch.as_tensor(xs), torch.as_tensor(ys),
                             torch.as_tensor(v), 1.3, family, nu)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= PALLAS_ATOL


@pytest.mark.parametrize("family,nu,gamma", FAMILIES[:4], ids=IDS[:4])
def test_f32_matmat_matches_the_jax_pallas_kernel_in_interpret_mode(
        family, nu, gamma):
    xs, ys, _, V = _pallas_operands(21, 150, 5, family, gamma)
    want = jax_mv._gram_matmat_pallas(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(V), 0.8, family=family,
        nu=float(nu), block_m=8, block_n=128, interpret=True)
    got = gram_matmat_scaled(torch.as_tensor(xs), torch.as_tensor(ys),
                             torch.as_tensor(V), 0.8, family, nu)
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
    x, y, v, V = (torch.as_tensor(a) for a in operands(6, 5, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        gram_matvec(x, y, v, deriv=True)
    for shape in ("dk", "dk_sq"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            gram_matmat(x, y, V, shape=shape)


def test_cpu_products_launch_nothing_and_both_kernels_are_registered():
    assert {"gram_matvec", "gram_matmat"} <= set(kernel_wrappers())
    before = launch_counts()
    x, y, v, V = (torch.as_tensor(a) for a in operands(6, 5, 2))
    gram_matvec(x, y, v)
    gram_matmat(x, y, V)
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
