"""Port parity: KernelFunction and the fused Gram of stpy_tpu_torch against
stpy_tpu, plus the port's static contracts.

Inputs come from numpy with a fixed seed and go through both packages on the
CPU (JAX in x64, torch in float64), where the fused-Gram wrapper runs its
plain PyTorch version. Tolerance: Gram values within 1e-12 relative to the
largest entry — both sides evaluate the same norm-expansion formula in f64,
so only the summation order differs.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu_torch import KernelFunction as TorchKernel

from torch_threads import one_torch_thread  # noqa: F401

GRAM_RTOL = 1e-12
REPO = Path(__file__).resolve().parent.parent

ATOMS = {
    "se": dict(kernel_name="squared_exponential", gamma=0.7),
    "ard": dict(kernel_name="ard", ard_gamma=[0.5, 0.8, 1.1]),
    "matern12": dict(kernel_name="matern", gamma=0.9, nu=0.5),
    "matern32": dict(kernel_name="matern", gamma=1.1, nu=1.5),
    "matern52": dict(kernel_name="matern", gamma=0.6, nu=2.5, kappa=1.7),
}
# every fused atom, one `+` and one `*` composite
CASES = list(ATOMS) + ["se+matern32", "ard*matern52"]
# the L1 atom has no double tier, so it is kept out of ATOMS and CASES
LAPLACE = dict(kernel_name="laplace", gamma=0.8, kappa=1.2)
LAPLACE_CASES = ["laplace", "laplace+se", "matern32*laplace"]


def make_kernel(cls, case, d=3, **kw):
    for op in ("+", "*"):
        if op in case:
            a, b = case.split(op)
            ka, kb = make_kernel(cls, a, d, **kw), make_kernel(cls, b, d, **kw)
            return ka + kb if op == "+" else ka * kb
    return cls(d=d, **{**ATOMS, "laplace": LAPLACE}[case], **kw)


def jax_kernel(case):
    return make_kernel(JaxKernel, case)


def torch_kernel(case, dtype=torch.float64):
    return make_kernel(TorchKernel, case, dtype=dtype, device="cpu")


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (40, 3)), rng.uniform(-1, 1, (23, 3))


@pytest.mark.parametrize("case", CASES + LAPLACE_CASES)
def test_cross_matches_jax(points, case):
    a, b = points
    want = jax_kernel(case).cross(jnp.asarray(a), jnp.asarray(b))
    got = torch_kernel(case).cross(a, b)
    assert got.shape == (40, 23) and got.dtype == torch.float64
    assert rel_err(got.numpy(), want) <= GRAM_RTOL


@pytest.mark.parametrize("case", CASES + LAPLACE_CASES)
def test_gram_and_diag_match_jax(points, case):
    a, _ = points
    jk, tk = jax_kernel(case), torch_kernel(case)
    G = tk.gram(a)
    J = np.asarray(jk.gram(jnp.asarray(a)))
    assert torch.equal(G, G.T)
    off = ~np.eye(len(a), dtype=bool)
    assert rel_err(G.numpy()[off], J[off]) <= GRAM_RTOL
    # on the diagonal sq = |x|² + |x|² − 2x·x cancels to a residual of
    # ~1e-16 on each side, which Matérn-½ turns into 1 − √sq: both sides
    # sit within 1e-7 of κ there, not 1e-12 of each other
    kd = tk.diag(a).numpy()
    assert rel_err(kd, jk.diag(jnp.asarray(a))) <= GRAM_RTOL
    assert np.max(np.abs(np.diag(G.numpy()) - kd) / kd) <= 1e-7
    assert np.max(np.abs(np.diag(J) - kd) / kd) <= 1e-7


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
