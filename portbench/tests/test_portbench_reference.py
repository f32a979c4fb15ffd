"""The plain reference against a closed-form float64 posterior in NumPy,
and its TF32 rounding."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import posterior as ref

ATOMS = {
    "matern32": [{"family": "matern", "nu": 1.5, "gamma": 0.5, "kappa": 1.0}],
    "se+matern32": [{"family": "se", "gamma": 0.5, "kappa": 1.0},
                    {"family": "matern", "nu": 1.5, "gamma": 0.8,
                     "kappa": 1.0}],
    "matern12_52": [{"family": "matern", "nu": 0.5, "gamma": 0.7,
                     "kappa": 0.5},
                    {"family": "matern", "nu": 2.5, "gamma": 0.9,
                     "kappa": 2.0}],
}


def _np_kernel(a, b, atoms):
    K = np.zeros((len(a), len(b)))
    for at in atoms:
        r = np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)) / at["gamma"]
        if at["family"] == "se":
            k = np.exp(-0.5 * r ** 2)
        elif at["nu"] == 0.5:
            k = np.exp(-r)
        elif at["nu"] == 1.5:
            k = (1 + math.sqrt(3) * r) * np.exp(-math.sqrt(3) * r)
        else:
            k = (1 + math.sqrt(5) * r + 5 * r ** 2 / 3) * np.exp(-math.sqrt(5) * r)
        K += at["kappa"] * k
    return K


def _closed_form(x, y, xt, atoms, s):
    K = _np_kernel(x, x, atoms) + s * s * np.eye(len(x))
    Ks = _np_kernel(xt, x, atoms)
    mu = Ks @ np.linalg.solve(K, y)
    var = (sum(a["kappa"] for a in atoms)
           - np.einsum("ij,ji->i", Ks, np.linalg.solve(K, Ks.T)))
    return mu, np.sqrt(var)


@pytest.mark.parametrize("name", sorted(ATOMS))
def test_reference_is_the_closed_form(name):
    rng = np.random.default_rng(7)
    d = 3
    x = rng.uniform(-1, 1, (150, d))
    y = np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(150)
    xt = rng.uniform(-1, 1, (40, d))
    mu64, sd64 = _closed_form(x, y, xt, ATOMS[name], 0.1)
    t = [torch.as_tensor(a) for a in (x, y, xt)]
    mu, sd, jitter = ref.posterior(*t, ATOMS[name], 0.1, "float64", 40, 25)
    assert jitter == 0.0
    assert np.abs(mu.numpy() - mu64).max() <= 1e-10 * np.abs(mu64).max()
    assert np.abs(sd.numpy() - sd64[:25]).max() <= 1e-10


@pytest.mark.parametrize("precision", ["float32", "tf32"])
def test_control_precisions_are_coarser(precision):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1500, 8)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.1 * rng.standard_normal(1500)).astype(
        np.float32)
    xt = rng.uniform(-1, 1, (200, 8)).astype(np.float32)
    t = [torch.as_tensor(a) for a in (x, y, xt)]
    atoms = ATOMS["matern32"]
    mu64, sd64, _ = ref.posterior(*t, atoms, 0.1, "float64", 200, 200)
    mu, sd, _ = ref.posterior(*t, atoms, 0.1, precision, 200, 200)
    assert mu.dtype == torch.float32
    err = float((mu.double() - mu64).abs().max() / mu64.abs().max())
    floor = {"float32": 1e-7, "tf32": 1e-5}[precision]
    assert floor < err < 1e-1


def test_tf32_rounding():
    # TF32 keeps 10 mantissa bits: its step at 1 is 2^-10, at 2-4 2^-9
    v = torch.tensor([1.0, -1.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -11 - 2 ** -20, -(3.0 + 2 ** -9), 0.0])
    r = ref.to_tf32(v)
    want = torch.tensor([1.0, -1.0, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                         -(3.0 + 2 ** -9), 0.0])
    assert torch.equal(r, want)
    x = torch.randn(10000)
    r = ref.to_tf32(x)
    assert float(((r - x).abs() / x.abs()).max()) <= 2 ** -11
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


def test_tf32_factor_and_solves_match_float32_on_exact_operands():
    """With operands TF32 holds exactly, the blocked TF32 routines are the
    float32 ones up to the order of their sums."""
    n = 2 * ref.NB + 100
    g = torch.Generator().manual_seed(0)
    W = ref.to_tf32(torch.randn(n, 64, generator=g) / 8)
    A = W @ W.T + 4.0 * torch.eye(n)
    L, _ = ref.cholesky(A, "tf32")
    assert float((L @ L.T - A).abs().max()) < 1e-3
    B = torch.randn(n, 5, generator=g)
    X = ref.solve_lower(L, B, "tf32")
    assert float((L @ X - B).abs().max()) < 1e-2
    Y = ref.solve_upper_t(L, B, "tf32")
    assert float((L.T @ Y - B).abs().max()) < 1e-2
