"""Port parity: the lower-triangle rank-k update and the fast blocked Cholesky
of stpy_tpu_torch (ops/syrk.py) against stpy_tpu/ops/pallas_syrk.py, and the
slice as a whole (benchmarks/exp_fastchol.py's pipeline at a small size), on
the CPU.

The same numpy inputs go through the port's plain versions (which the
wrappers run for CPU tensors) and through the JAX Pallas kernels in
interpret mode, with small nb and block, as tests/test_pallas_syrk.py runs
them. The JAX update splits W into bf16 halves (bf16x3, Precision.HIGH
accuracy); the port's plain version computes in f32, which is the whole gap
between them. The card kernel keeps the JAX kernel's three products with
TF32 halves (`split_tf32`); its split and the three-term product are held
here, in plain PyTorch, against float64 and the JAX kernel. Tolerances,
each with its reason beside it below.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu import linalg as jl
from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu.ops.pallas_syrk import chol_blocked_syrk as jax_chol_blocked
from stpy_tpu.ops.pallas_syrk import syrk_update_lower as jax_syrk
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch import linalg as tl
from stpy_tpu_torch.ops import kernel_wrappers, launch_counts
from stpy_tpu_torch.ops.syrk import (
    chol_blocked_syrk,
    split_tf32,
    syrk_update_lower,
    syrk_update_lower_,
    syrk_update_lower_plain_,
)

from test_torch_port_chol_leaf import rel_to_factor, se_gram
from test_torch_port_gram_matvec import _FakeCuda
from torch_threads import one_torch_thread  # noqa: F401

# syrk, lower triangle, error over (|W||W|ᵀ)ᵢⱼ: JAX's bf16x3 measures ~5.6e-6
# against float64, so port vs JAX 2e-5; a plain f32 product ~5.7e-7 at
# k = 128, so port vs float64 2e-6.
SYRK_JAX_RTOL, SYRK_F64_RTOL = 2e-5, 2e-6
# blocked factor, error over max|L64|: JAX's bf16x3 trailing updates put it
# at ~5.2e-5 from float64, so port vs JAX 2e-4; the port is an f32
# factorization (~4e-6 here), held to float64 at 2e-5.
CHOL_JAX_RTOL, CHOL_F64_RTOL = 2e-4, 2e-5
# posterior of the slice against a torch-float64 posterior: the single
# tier's bars (mean 1e-4, variance max 1e-2); against the JAX pipeline the
# mean bar doubles, as both sides carry their own factor's error (JAX's
# ~2.6e-5 mean, 1.4e-3 variance max).
MEAN_RTOL, VAR_RTOL, MEAN_JAX_RTOL = 1e-4, 1e-2, 2e-4
S = 0.1


def syrk_operands(m, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, m)).astype(np.float32),
            rng.standard_normal((m, k)).astype(np.float32))


def lower_errors(got, T, W):
    """max over i ≥ j of |got − (T − WWᵀ)| / (|W||W|ᵀ), in float64."""
    W64 = W.astype(np.float64)
    ref = T.astype(np.float64) - W64 @ W64.T
    scale = np.abs(W64) @ np.abs(W64).T
    il = np.tril_indices(T.shape[0])
    return np.abs(np.asarray(got, np.float64) - ref)[il] / scale[il]


@pytest.mark.parametrize("m, k", [(192, 128), (100, 70)])
def test_syrk_update_lower_matches_jax_and_float64(m, k):
    """(100, 70) is ragged for every tile of both packages."""
    T, W = syrk_operands(m, k, seed=m)
    got = syrk_update_lower(torch.as_tensor(T), torch.as_tensor(W), block=64,
                            block_k=64)
    assert got.dtype == torch.float32 and got.shape == (m, m)
    want = np.asarray(jax_syrk(jnp.asarray(T), jnp.asarray(W), block=64,
                               block_k=64, interpret=True))
    scale = np.abs(W.astype(np.float64)) @ np.abs(W.astype(np.float64)).T
    il = np.tril_indices(m)
    assert np.max(np.abs(got.numpy().astype(np.float64) - want)[il]
                  / scale[il]) <= SYRK_JAX_RTOL
    assert np.max(lower_errors(got.numpy(), T, W)) <= SYRK_F64_RTOL
    assert np.max(lower_errors(want, T, W)) <= SYRK_JAX_RTOL


def tf32_reference(a):
    """cvt.rna.tf32.f32 in numpy: the float32 bits plus 0x1000, the 13 low
    bits cleared (unsigned, wrapping as the card's uint32 does)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("m, k", [(192, 128), (100, 70)])
def test_split_tf32_halves_are_tf32_exact(m, k):
    """hi = tf32(W), lo = tf32(W − hi), each with its 13 low bits 0; hi is
    the card's rounding bit for bit, ties (the 0x1000 bit alone) and a
    carry into the exponent included."""
    _, W = syrk_operands(m, k, seed=m)
    W[0, :4] = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 2 - 2.0 ** -23,
                         0.0], np.float32)
    hi, lo = split_tf32(torch.as_tensor(W))
    assert hi.dtype == lo.dtype == torch.float32
    for half in (hi, lo):
        assert not (half.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), tf32_reference(W))
    np.testing.assert_array_equal(lo.numpy(), tf32_reference(W - hi.numpy()))
    assert hi[0, :4].tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 2.0, 0.0]


@pytest.mark.parametrize("m, k", [(192, 128), (100, 70)])
def test_split_tf32_error_is_within_2_to_the_minus_22(m, k):
    _, W = syrk_operands(m, k, seed=m)
    hi, lo = (h.numpy().astype(np.float64) for h in split_tf32(torch.as_tensor(W)))
    W64 = W.astype(np.float64)
    assert np.all(np.abs(W64 - hi - lo) <= 2.0 ** -22 * np.abs(W64))


@pytest.mark.parametrize("m, k", [(192, 128), (100, 70)])
def test_three_term_tf32_product_matches_float64_and_jax(m, k):
    """The card kernel's arithmetic without its f32 sums: T − (hi·hiᵀ +
    hi·loᵀ + lo·hiᵀ) in float64. Its dropped lo·loᵀ and the split's
    residual are a few 2⁻²² of |W_ip W_jp|, within the f32 bar against
    float64 and the bf16x3 bar against the JAX kernel."""
    T, W = syrk_operands(m, k, seed=m)
    hi, lo = (h.numpy().astype(np.float64) for h in split_tf32(torch.as_tensor(W)))
    got = T.astype(np.float64) - (hi @ hi.T + hi @ lo.T + lo @ hi.T)
    assert np.max(lower_errors(got, T, W)) <= SYRK_F64_RTOL
    want = np.asarray(jax_syrk(jnp.asarray(T), jnp.asarray(W), block=64,
                               block_k=64, interpret=True), np.float64)
    scale = np.abs(W.astype(np.float64)) @ np.abs(W.astype(np.float64)).T
    il = np.tril_indices(m)
    assert np.max(np.abs(got - want)[il] / scale[il]) <= SYRK_JAX_RTOL


def test_in_place_update_of_a_trailing_view_equals_the_copy():
    """syrk_update_lower_ on the strided trailing block of a factor equals
    the out-of-place update on its lower triangle, leaves the strict upper
    triangle of its view as it was, and touches nothing outside the view."""
    rng = np.random.default_rng(5)
    buf = torch.as_tensor(rng.standard_normal((120, 120)), dtype=torch.float32)
    before = buf.clone()
    T, W = buf[40:, 40:], buf[40:, :30]
    want = syrk_update_lower(T.clone(), W.clone(), block=32)
    out = syrk_update_lower_(T, W, block=32)
    assert out.data_ptr() == T.data_ptr() and not T.is_contiguous()
    il = np.tril_indices(80)
    assert torch.equal(T[il], want[il])
    iu = np.triu_indices(80, 1)
    assert torch.equal(T[iu], before[40:, 40:][iu])
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[40:, 40:] = False
    assert torch.equal(buf[outside], before[outside])


def test_plain_row_blocks_change_only_the_summation_grouping():
    T, W = (torch.as_tensor(a) for a in syrk_operands(90, 20, seed=6))
    il = np.tril_indices(90)
    a = syrk_update_lower_plain_(T.clone(), W, block=512)[il]
    b = syrk_update_lower_plain_(T.clone(), W, block=16)[il]
    assert torch.allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [256, 200])
def test_chol_blocked_syrk_matches_jax_and_float64(n):
    """nb = 64, block = 32: four blocks (n = 200 padded to 256 with an
    identity block), three trailing updates."""
    K = se_gram(n)
    L64 = np.linalg.cholesky(K.astype(np.float64))
    L = chol_blocked_syrk(torch.as_tensor(K), nb=64, block=32)
    assert L.dtype == torch.float32 and L.shape == (n, n)
    Lj = np.asarray(jax_chol_blocked(jnp.asarray(K), nb=64, block=32,
                                     interpret=True))
    assert rel_to_factor(L, L64) <= CHOL_F64_RTOL
    assert rel_to_factor(Lj, L64) <= CHOL_JAX_RTOL
    assert np.max(np.abs(L.numpy() - Lj)) / np.max(np.abs(L64)) <= CHOL_JAX_RTOL
    assert (np.triu(L.numpy(), 1) == 0).all()


def test_chol_blocked_syrk_of_an_indefinite_matrix_is_not_finite():
    L = chol_blocked_syrk(-torch.eye(128), nb=64, block=32)
    assert not bool(torch.isfinite(L).all())


@pytest.mark.parametrize("nb", [512, 2048])
def test_chol_blocked_syrk_at_1500_against_float64(nb):
    """n = 1500, padded to 1536 (three blocks of 512) or to 2048 (one block,
    which `_leaf_chol_` splits into two 1024 leaves: the split's inverse and
    products run). At this size the SE Gram's conditioning puts torch's own
    f32 LAPACK factor ~1.45e-5 from float64, so the port is held to twice
    that factor's error on the same input: f32 quality, not a fixed 2e-5."""
    K = se_gram(1500)
    L64 = np.linalg.cholesky(K.astype(np.float64))
    lapack32 = rel_to_factor(torch.linalg.cholesky(torch.as_tensor(K)), L64)
    L = chol_blocked_syrk(torch.as_tensor(K), nb=nb)
    assert L.shape == (1500, 1500)
    assert rel_to_factor(L, L64) <= 2 * lapack32
    assert (np.triu(L.numpy(), 1) == 0).all()


def test_cuda_syrk_wrapper_checks_its_inputs():
    T, W = (torch.as_tensor(a) for a in syrk_operands(16, 4, seed=7))
    with pytest.raises(TypeError, match="float32"):
        syrk_update_lower_(T.double().as_subclass(_FakeCuda),
                           W.double().as_subclass(_FakeCuda))
    with pytest.raises(ValueError, match="unit"):
        syrk_update_lower_(T.T.as_subclass(_FakeCuda), W.as_subclass(_FakeCuda))
    with pytest.raises(ValueError, match="shapes"):
        syrk_update_lower_(T[:, :8], W)
    with pytest.raises(TypeError, match="float32"):
        chol_blocked_syrk(T.double().as_subclass(_FakeCuda))


def test_cpu_updates_launch_nothing_and_the_kernel_is_registered():
    assert kernel_wrappers()["syrk_lower"] is syrk_update_lower_
    before = launch_counts()
    T, W = (torch.as_tensor(a) for a in syrk_operands(40, 8, seed=8))
    syrk_update_lower(T, W)
    chol_blocked_syrk(torch.as_tensor(se_gram(100)), nb=32, block=16)
    assert launch_counts() == before


def test_fast_pipeline_matches_jax_and_float64():
    """benchmarks/exp_fastchol.py's fast variant at n = 256, d = 3, all f32:
    SE Gram + s²I, the blocked factor (nb = 64, block = 32), cho_solve,
    mean, trisolve, variance -- the port against a torch-float64 posterior
    and against the same pipeline in the JAX package (interpret mode)."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    y = (np.sin(3 * x[:, :1]) + S * rng.standard_normal((256, 1))).astype(
        np.float32)
    xt = rng.uniform(-1, 1, (128, 3)).astype(np.float32)

    tk = TorchKernel(kernel_name="squared_exponential", gamma=0.5, d=3,
                     dtype=torch.float32, device="cpu")
    xs, ys, xts = (torch.as_tensor(a) for a in (x, y, xt))
    A = tk.eval_params(tk.params_dict, xs, xs)
    A.diagonal().add_(S * S)
    L = chol_blocked_syrk(A, nb=64, block=32)
    Ks = tk.eval_params(tk.params_dict, xts, xs)
    mu = (Ks @ tl.cho_solve_blocked(L, ys))[:, 0].double().numpy()
    V = tl.tri_solve_blocked(L, Ks.T)
    var = (tk.diag(xts) - (V * V).sum(0)).double().numpy()

    jk = JaxKernel(kernel_name="squared_exponential", gamma=0.5, d=3)
    xj, yj, xtj = (jnp.asarray(a) for a in (x, y, xt))
    Aj = jk.eval_params(jk.params_dict, xj, xj).astype(jnp.float32)
    Aj = Aj + (S * S) * jnp.eye(256, dtype=jnp.float32)
    Lj = jax_chol_blocked(Aj, nb=64, block=32, interpret=True)
    Ksj = jk.eval_params(jk.params_dict, xtj, xj).astype(jnp.float32)
    mu_j = np.asarray(Ksj @ jl.cho_solve_blocked(Lj, yj), np.float64)[:, 0]
    Vj = jl.tri_solve_blocked(Lj, Ksj.T)
    var_j = np.asarray(1.0 - jnp.sum(Vj * Vj, axis=0), np.float64)

    x64, y64, xt64 = (torch.as_tensor(a, dtype=torch.float64)
                      for a in (x, y, xt))
    k64 = TorchKernel(kernel_name="squared_exponential", gamma=0.5, d=3,
                      dtype=torch.float64, device="cpu")
    A64 = k64.eval_params(k64.params_dict, x64, x64)
    A64.diagonal().add_(S * S)
    L64 = torch.linalg.cholesky(A64)
    Ks64 = k64.eval_params(k64.params_dict, xt64, x64)
    mu64 = (Ks64 @ torch.cholesky_solve(y64, L64))[:, 0].numpy()
    V64 = torch.linalg.solve_triangular(L64, Ks64.T, upper=False)
    var64 = (1.0 - (V64 * V64).sum(0)).numpy()

    def mean_err(m):
        return np.max(np.abs(m - mu64)) / np.max(np.abs(mu64))

    assert mean_err(mu) <= MEAN_RTOL
    assert np.max(np.abs(var - var64) / var64) <= VAR_RTOL
    assert np.max(np.abs(mu - mu_j)) / np.max(np.abs(mu64)) <= MEAN_JAX_RTOL
    assert np.max(np.abs(var - var_j) / var64) <= VAR_RTOL
