"""Port parity: the Laplace (L1) Gram of stpy_tpu_torch against stpy_tpu.

Inputs come from numpy with a fixed seed. On the CPU the JAX `gram_laplace`
takes its jnp path (`manhattan_dist`, x64) and the port's wrapper runs its
plain PyTorch version: both sum |x − y| in f64, so they agree within 1e-12
relative to the largest entry. The JAX Pallas kernel in interpret mode
computes in f32: against it the bound is 1e-6 absolute on entries ≤ κ = 1.3
(d + 1 f32 roundings of a distance below 8, times |dK/dD| ≤ κ/γ²·e⁻¹).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu.ops import pallas_gram as jg
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch.kernels import functions as F
from stpy_tpu_torch.ops.gram import gram
from stpy_tpu_torch.ops.gram_l1 import gram_l1, gram_l1_plain, gram_laplace

GRAM_RTOL = 1e-12
F32_ATOL = 1e-6
KAPPA = 1.3


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def points(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, d)), rng.uniform(-1, 1, (m, d))


@pytest.mark.parametrize("n,m,d,gamma", [
    (1, 1, 1, 0.5), (40, 23, 3, 0.8), (17, 64, 9, 2.0), (33, 5, 130, 3.0),
])
def test_gram_laplace_matches_jax_jnp_path(n, m, d, gamma):
    a, b = points(n, m, d)
    want = jg.gram_laplace(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gamma),
                           KAPPA)
    got = gram_laplace(torch.as_tensor(a), torch.as_tensor(b),
                       torch.tensor(gamma, dtype=torch.float64), KAPPA)
    assert got.shape == (n, m) and got.dtype == torch.float64
    assert rel_err(got.numpy(), want) <= GRAM_RTOL


@pytest.mark.parametrize("n,m,d", [(40, 23, 3), (300, 130, 8), (9, 260, 1)])
def test_gram_l1_matches_the_jax_pallas_kernel_in_interpret_mode(n, m, d):
    a, b = points(n, m, d, seed=1)
    gamma = 1.7
    want = jg._gram_l1_pallas(jnp.asarray(a, jnp.float32),
                              jnp.asarray(b, jnp.float32),
                              1.0 / gamma ** 2, KAPPA, block_m=128,
                              block_n=128, interpret=True)
    got = gram_l1(torch.as_tensor(a, dtype=torch.float32),
                  torch.as_tensor(b, dtype=torch.float32), 1.0 / gamma ** 2,
                  KAPPA)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= F32_ATOL


def test_f32_plain_version_matches_f64():
    a, b = points(50, 70, 8, seed=2)
    x32, y32 = (torch.as_tensor(v, dtype=torch.float32) for v in (a, b))
    got = gram_l1_plain(x32, y32, 0.25, KAPPA)
    want = gram_l1_plain(x32.double(), y32.double(), 0.25, KAPPA)
    assert (got.double() - want).abs().max() <= F32_ATOL


def test_plain_version_is_the_l1_formula_and_differentiable():
    a, b = points(6, 4, 3, seed=3)
    D = np.abs(a[:, None] - b[None]).sum(-1)
    assert np.allclose(F.manhattan_dist(torch.as_tensor(a),
                                        torch.as_tensor(b)).numpy(), D,
                       rtol=1e-15, atol=0)
    gamma = torch.tensor(0.9, dtype=torch.float64, requires_grad=True)
    K = gram_laplace(torch.as_tensor(a), torch.as_tensor(b), gamma, KAPPA)
    assert np.allclose(K.detach().numpy(), KAPPA * np.exp(-D / 0.81),
                       rtol=1e-14, atol=0)
    K.sum().backward()
    dgamma = (KAPPA * np.exp(-D / 0.81) * D * 2 / 0.9 ** 3).sum()
    assert float(gamma.grad) == pytest.approx(dgamma, rel=1e-12)


def test_gram_family_laplace_routes_to_the_l1_gram():
    a, b = points(8, 5, 2, seed=4)
    x, y = torch.as_tensor(a), torch.as_tensor(b)
    assert torch.equal(gram(x, y, family="laplace", gamma=0.6, kappa=KAPPA),
                       gram_laplace(x, y, 0.6, KAPPA))


def test_port_laplace_is_the_l1_kernel_where_the_reference_double_tier_is_not():
    """The JAX package's double tier maps the laplace atom to the L2
    Matérn-½ (stpy_tpu/kernels/df_plan.py:56-57), its single tier computes
    the L1 kernel. The port follows the single tier and the original stpy,
    and its double tier raises instead (ROADMAP Queue 3)."""
    x = np.random.default_rng(0).uniform(-1, 1, (40, 3))
    jk = JaxKernel(kernel_name="laplace", gamma=0.7, d=3)
    single = np.asarray(jk.cross(jnp.asarray(x), jnp.asarray(x)))
    h, l = jax_df_plan.df_gram_from_desc(jk, jk.params_dict, jnp.asarray(x),
                                         jnp.asarray(x),
                                         jax_df_plan.df_atom_desc(jk))
    double = np.asarray(h, np.float64) + np.asarray(l, np.float64)
    assert np.max(np.abs(single - double)) > 0.3
    tk = TorchKernel(kernel_name="laplace", gamma=0.7, d=3,
                     dtype=torch.float64, device="cpu")
    assert rel_err(tk.cross(x, x).numpy(), single) <= GRAM_RTOL
