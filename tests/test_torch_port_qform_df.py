"""Port parity: the fused double-float quadratic form of stpy_tpu_torch
against stpy_tpu.

On the CPU in x64 the JAX `qform_refined` takes its f64 branch
(`_qform_f64`); the port's wrapper runs its plain PyTorch version, the same
f64 evaluation. Tolerance: hi + lo within 1e-13 of the scale
Σ_a |W0a|·(2|B| + |A|·|W0k| + s²|W0a|) — both are f64 evaluations that sum
in different orders. Against the JAX Pallas kernel in interpret mode (f32
operands, bf16 passes for Tl) the bound is that kernel's own test floor,
2e-6 (tests/test_blocked_solves.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.ops import pallas_qform_df as jq
from stpy_tpu_torch.ops.qform_df import (
    qform_df_plain,
    qform_refined,
    qform_refined_strip,
)

QFORM_RTOL = 1e-13
S = 0.35


def setup(n=96, t=40, s=S, seed=4):
    """SE Gram K (n, n) with a lo part, cross Gram B (n, t) with a lo part,
    the exact solve of (K + s²I) W = B and the true quadratic form."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    xt = rng.uniform(-1, 1, (t, 2))
    K = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / 0.5)
    B = np.exp(-((x[:, None] - xt[None]) ** 2).sum(-1) / 0.5)
    Kh, Kl = split(K)
    Bh, Bl = split(B)
    A = Kh + Kl + s * s * np.eye(n)
    W = np.linalg.solve(A, Bh + Bl)
    q_true = np.einsum("nt,nt->t", Bh + Bl, W)
    return Kh, Kl, Bh, Bl, W, q_true


def split(a):
    hi = a.astype(np.float32).astype(np.float64)
    return hi, (a - hi).astype(np.float32).astype(np.float64)


def scale(Th, Tl, W0k, W0a, Bh, Bl, s):
    return (np.abs(W0a) * (2 * np.abs(Bh + Bl) + np.abs(Th + Tl) @ np.abs(W0k)
                           + s * s * np.abs(W0a))).sum(0)


def value(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def port(fn, *arrays, s=S):
    return fn(*(torch.as_tensor(a) for a in arrays), s)


@pytest.mark.parametrize("n,t", [(1, 1), (96, 40), (130, 7)])
def test_qform_refined_matches_jax_f64_branch(n, t):
    Kh, Kl, Bh, Bl, W, _ = setup(n, t)
    W0 = W + 1e-4 * np.random.default_rng(1).standard_normal(W.shape)
    want = jq.qform_refined(*(jnp.asarray(a) for a in (Kh, Kl, W0, Bh, Bl)),
                            jnp.asarray(S))
    got = port(qform_refined, Kh, Kl, W0, Bh, Bl)
    assert got[0].shape == got[1].shape == (t,)
    err = np.abs(value(got) - value(want)) / scale(Kh, Kl, W0, W0, Bh, Bl, S)
    assert np.max(err) <= QFORM_RTOL


@pytest.mark.parametrize("r0,r1", [(0, 37), (37, 96), (5, 6)])
def test_qform_refined_strip_matches_jax_f64_branch(r0, r1):
    Kh, Kl, Bh, Bl, W, _ = setup()
    W0 = W + 1e-4 * np.random.default_rng(2).standard_normal(W.shape)
    strip = (Kh[r0:r1], Kl[r0:r1], W0, W0[r0:r1], Bh[r0:r1], Bl[r0:r1])
    want = jq.qform_refined_strip(*(jnp.asarray(a) for a in strip),
                                  jnp.asarray(S))
    got = port(qform_refined_strip, *strip)
    err = np.abs(value(got) - value(want)) / scale(*strip, S)
    assert np.max(err) <= QFORM_RTOL


def test_strips_add_up_to_the_square_call():
    Kh, Kl, Bh, Bl, W, _ = setup()
    W0 = W + 1e-4 * np.random.default_rng(3).standard_normal(W.shape)
    total = sum(value(port(qform_refined_strip, Kh[r0:r1], Kl[r0:r1], W0,
                           W0[r0:r1], Bh[r0:r1], Bl[r0:r1]))
                for r0, r1 in ((0, 30), (30, 31), (31, 96)))
    square = value(port(qform_refined, Kh, Kl, W0, Bh, Bl))
    err = np.abs(total - square) / scale(Kh, Kl, W0, W0, Bh, Bl, S)
    assert np.max(err) <= QFORM_RTOL


def test_qform_matches_the_jax_pallas_kernel_in_interpret_mode():
    """The JAX kernel on f32 operands (its Ozaki main product, one bf16
    pass for Tl, df epilogue) against the port's f64 evaluation of the same
    f32 inputs."""
    Kh, Kl, Bh, Bl, W, q_true = setup(n=256, t=128)
    W0 = W + 1e-4 * np.random.default_rng(6).standard_normal(W.shape)
    f32 = [a.astype(np.float32) for a in (Kh, Kl, W0, Bh, Bl)]
    qh, ql = jq.qform_refined(*(jnp.asarray(a) for a in f32), jnp.asarray(S),
                              block_m=128, block_n=128, block_k=128,
                              interpret=True)
    got = port(qform_refined, *f32)
    assert got[0].dtype == got[1].dtype == torch.float32
    want = np.asarray(qh, np.float64) + np.asarray(ql, np.float64)
    assert np.max(np.abs(value(got) - want)
                  / np.maximum(np.abs(want), 1e-3)) < 2e-6
    assert np.max(np.abs(value(got) - q_true) / q_true) < 2e-5


def test_qform_undershoots_at_second_order():
    """q̃ = 2bᵀw0 − w0ᵀA w0 falls short of bᵀA⁻¹b by rᵀA⁻¹r ≥ 0, which is
    quadratic in the solve residual r = B − A·W0."""
    Kh, Kl, Bh, Bl, W, q_true = setup(n=256, t=96)
    A = Kh + Kl + S * S * np.eye(256)
    rng = np.random.default_rng(5)
    for noise in (1e-3, 1e-5):
        W0 = W + noise * rng.standard_normal(W.shape)
        err = q_true - value(port(qform_refined, Kh, Kl, W0, Bh, Bl))
        assert err.min() > -1e-9
        r = Bh + Bl - A @ W0
        assert np.all(err <= ((r * r).sum(0) / S ** 2 + 1e-9) * 1.01)
        if noise == 1e-5:
            assert np.max(np.abs(err) / q_true) < 1e-6


def test_plain_version_is_the_f64_formula():
    Kh, Kl, Bh, Bl, W, _ = setup(n=20, t=9)
    qh, ql = qform_df_plain(*(torch.as_tensor(a) for a in (Kh, Kl, W, W, Bh, Bl)),
                            S * S)
    want = ((Bh + Bl) * W).sum(0) * 2 - (W * ((Kh + Kl + S * S * np.eye(20)) @ W)).sum(0)
    assert np.allclose(qh.numpy() + ql.numpy(), want, rtol=1e-14, atol=0)
    assert np.array_equal(qh.numpy(), qh.numpy().astype(np.float32))


def test_qform_rejects_mismatched_shapes():
    A = torch.zeros((4, 5))
    W = torch.zeros((5, 3))
    C = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        qform_refined_strip(A, A, W, C, C, torch.zeros((3, 4)), 0.1)
    with pytest.raises(ValueError):
        qform_refined_strip(A, torch.zeros((4, 4)), W, C, C, C, 0.1)
    with pytest.raises(ValueError):
        qform_refined_strip(A, A, torch.zeros((4, 3)), C, C, C, 0.1)
