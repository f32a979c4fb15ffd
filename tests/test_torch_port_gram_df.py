"""Port parity: the double-float (hi, lo) Gram of stpy_tpu_torch against
stpy_tpu.

On the CPU in x64 the JAX `gram_df` returns its exact f64 reference split
into (hi, lo) (`pallas_gram_df._f64_reference`); the port's wrapper runs its
plain PyTorch version. Tolerance: hi + lo within 1e-13 relative, entry by
entry — both are f64 evaluations of the same formula; the port also rounds
lo to f32 (~eps32² ≈ 4e-15 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import df_plan as jax_df_plan
from stpy_tpu.ops.pallas_gram_df import gram_df as jax_gram_df
from stpy_tpu_torch.kernels import df_plan
from stpy_tpu_torch.ops.gram_df import df_add, df_mul, gram_df, split_f64

from test_torch_port_gram import CASES, jax_kernel, torch_kernel

DF_RTOL = 1e-13


def pair_value(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def entry_rel_err(got, want):
    return np.max(np.abs(got - want) / np.abs(want))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(1)
    return rng.uniform(-1, 1, (37, 3)), rng.uniform(-1, 1, (29, 3))


@pytest.mark.parametrize("family,nu,gamma", [
    ("se", 1.0, 0.8),
    ("se", 1.0, [0.5, 0.9, 1.3]),
    ("matern", 0.5, 0.7),
    ("matern", 1.5, 1.1),
    ("matern", 2.5, 0.6),
    ("matern", 1.5, [0.4, 1.0, 1.7]),
], ids=["se", "se-ard", "matern12", "matern32", "matern52", "matern32-ard"])
def test_gram_df_matches_jax_f64_reference(points, family, nu, gamma):
    a, b = points
    kappa = 1.3
    jh, jl = jax_gram_df(jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(gamma), kappa, family=family, nu=nu)
    th, tl = gram_df(torch.as_tensor(a), torch.as_tensor(b),
                     torch.as_tensor(gamma, dtype=torch.float64), kappa,
                     family=family, nu=nu)
    assert th.dtype == tl.dtype == torch.float32
    assert entry_rel_err(pair_value(th, tl), pair_value(jh, jl)) <= DF_RTOL
    # hi is the f32 rounding of the pair's value; lo is below half an ulp
    value = pair_value(th, tl)
    assert np.array_equal(th.numpy(), value.astype(np.float32))
    assert np.all(np.abs(tl.numpy()) <= np.spacing(np.abs(th.numpy())) / 2)


@pytest.mark.parametrize("case", CASES)
def test_df_gram_from_desc_matches_jax(points, case):
    a, b = points
    jk, tk = jax_kernel(case), torch_kernel(case)
    jh, jl = jax_df_plan.df_gram_from_desc(
        jk, jk.params_dict, jnp.asarray(a), jnp.asarray(b),
        jax_df_plan.df_atom_desc(jk))
    th, tl = df_plan.df_gram_from_desc(
        tk, tk.params_dict, torch.as_tensor(a), torch.as_tensor(b),
        df_plan.df_atom_desc(tk))
    assert entry_rel_err(pair_value(th, tl), pair_value(jh, jl)) <= DF_RTOL


def test_f32_inexact_gamma_keeps_its_f64_value(points):
    """γ = 1.1 is not an f32 number; the port's f64 hyperparameters carry
    it in full (the JAX package needs lo-limb shadows for this)."""
    a, b = points
    th, tl = gram_df(torch.as_tensor(a, dtype=torch.float32),
                     torch.as_tensor(b, dtype=torch.float32),
                     torch_kernel("matern32").params_dict["0"]["gamma"],
                     1.0, family="matern", nu=1.5)
    a32 = a.astype(np.float32).astype(np.float64)
    b32 = b.astype(np.float32).astype(np.float64)
    r = np.sqrt(((a32[:, None] - b32[None]) ** 2).sum(-1)) / 1.1
    t = np.sqrt(3.0) * r
    want = (1 + t) * np.exp(-t)
    assert entry_rel_err(pair_value(th, tl), want) <= DF_RTOL


def test_df_add_and_mul_fold_in_f64():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.1, 2.0, 64))
    y = torch.as_tensor(rng.uniform(0.1, 2.0, 64))
    xh, xl = split_f64(x)
    yh, yl = split_f64(y)
    for fold, want in ((df_add, x + y), (df_mul, x * y)):
        h, l = fold(xh, xl, yh, yl)
        got = h.double() + l.double()
        assert torch.max(torch.abs(got - want) / want) <= DF_RTOL
