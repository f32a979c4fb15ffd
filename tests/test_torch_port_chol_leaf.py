"""Port parity: the Cholesky leaf of stpy_tpu_torch (ops/chol_leaf.py) against
stpy_tpu/ops/pallas_chol.py, on the CPU.

The same numpy SE Gram (d = 3, γ = 0.5, s = 0.1, float32) goes through the
port's plain version (which the wrapper runs for CPU tensors) and through
the JAX Pallas kernel in interpret mode, as tests/test_pallas_syrk.py runs
the Pallas bodies. Errors are relative to the largest entry of the float64
factor (LAPACK on the same f32 input). Tolerances:
* port against float64, 2e-5: an f32 factorization of this Gram; the plain
  version measures ~3e-6 at n ≤ 256, torch's f32 LAPACK factor ~2.8e-6;
* port against JAX, 5e-5: the JAX kernel runs its products at HIGHEST in
  interpret mode and measures ~8e-6 against float64; 5e-5 leaves room for
  both sides' f32 rounding on other summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.ops.pallas_chol import chol_leaf as jax_chol_leaf
from stpy_tpu_torch.ops import kernel_wrappers, launch_counts
from stpy_tpu_torch.ops.chol_leaf import MAX_LEAF, _leaf_size, chol_leaf, chol_leaf_

from test_torch_port_gram_matvec import _FakeCuda
from torch_threads import one_torch_thread  # noqa: F401

F64_RTOL = 2e-5
JAX_RTOL = 5e-5


def se_gram(n, d=3, gamma=0.5, s=0.1, seed=0):
    """K(x, x) + s²I for x ~ U(-1, 1)^(n×d), in float32."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, d))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    return (np.exp(-sq / (2 * gamma ** 2)) + s * s * np.eye(n)).astype(
        np.float32)


def rel_to_factor(L, L64):
    return np.max(np.abs(np.asarray(L, np.float64) - L64)) / np.max(np.abs(L64))


@pytest.mark.parametrize("n", [256, 200])
def test_chol_leaf_matches_jax_and_float64(n):
    """n = 256: two of the JAX kernel's 128-column panels, eight of the
    port's 32-column ones; n = 200: JAX pads to 256, the port masks."""
    K = se_gram(n)
    L64 = np.linalg.cholesky(K.astype(np.float64))
    L = chol_leaf(torch.as_tensor(K))
    assert L.dtype == torch.float32 and L.shape == (n, n)
    Lj = np.asarray(jax_chol_leaf(jnp.asarray(K), interpret=True))
    assert rel_to_factor(L, L64) <= F64_RTOL
    assert rel_to_factor(Lj, L64) <= F64_RTOL
    assert np.max(np.abs(L.numpy() - Lj)) / np.max(np.abs(L64)) <= JAX_RTOL
    assert (np.triu(L.numpy(), 1) == 0).all()


def test_indefinite_leaf_gives_non_finite_like_jax():
    A = -np.eye(64, dtype=np.float32)
    assert not bool(torch.isfinite(chol_leaf(torch.as_tensor(A))).all())
    assert not bool(jnp.all(jnp.isfinite(jax_chol_leaf(jnp.asarray(A),
                                                         interpret=True))))


def test_only_the_lower_triangle_is_read():
    K = se_gram(100, seed=1)
    junk = K.copy()
    junk[np.triu_indices(100, 1)] = np.nan
    assert torch.equal(chol_leaf(torch.as_tensor(junk)),
                       chol_leaf(torch.as_tensor(K)))


def test_in_place_leaf_on_a_strided_block_equals_the_copy():
    """chol_leaf_ factors a diagonal block of a larger buffer in place and
    touches nothing outside it."""
    K = se_gram(70, seed=2)
    buf = torch.as_tensor(
        np.random.default_rng(3).standard_normal((100, 90)), dtype=torch.float32)
    before = buf.clone()
    view = buf[10:80, 15:85]
    view.copy_(torch.as_tensor(K))
    out = chol_leaf_(view)
    assert out.data_ptr() == view.data_ptr()
    assert torch.equal(view, chol_leaf(torch.as_tensor(K)))
    outside = torch.ones_like(buf, dtype=torch.bool)
    outside[10:80, 15:85] = False
    assert torch.equal(buf[outside], before[outside])


@pytest.mark.parametrize("wrapper", [chol_leaf, chol_leaf_])
def test_cuda_wrappers_take_float32_leaves_up_to_1024(wrapper):
    with pytest.raises(TypeError, match="float32"):
        wrapper(torch.eye(8, dtype=torch.float64).as_subclass(_FakeCuda))
    big = torch.zeros((MAX_LEAF + 1, MAX_LEAF + 1)).as_subclass(_FakeCuda)
    with pytest.raises(ValueError, match="1024"):
        wrapper(big)
    with pytest.raises(ValueError, match="square"):
        wrapper(torch.zeros((8, 9)).as_subclass(_FakeCuda))


def test_leaf_validation_of_the_kernel():
    """The checks the CUDA wrappers make before a launch, on CPU tensors:
    square, n ≤ 1024, rows of unit stride; the out-of-place wrapper also
    wants a contiguous matrix."""
    assert _leaf_size(torch.zeros((MAX_LEAF, MAX_LEAF))) == MAX_LEAF
    assert _leaf_size(torch.zeros((64, 80))[:, :64]) == 64
    with pytest.raises(ValueError, match="1024"):
        _leaf_size(torch.zeros((MAX_LEAF + 1, MAX_LEAF + 1)))
    for strided in (torch.zeros((64, 64)).T, torch.zeros((64, 128))[:, ::2]):
        with pytest.raises(ValueError, match="unit"):
            _leaf_size(strided)
    with pytest.raises(ValueError, match="contiguous"):
        chol_leaf(torch.zeros((64, 80))[:, :64].as_subclass(_FakeCuda))


def test_cpu_leaf_launches_nothing_and_the_kernel_is_registered():
    assert kernel_wrappers()["chol_leaf"] is chol_leaf_
    before = launch_counts()
    chol_leaf(torch.as_tensor(se_gram(40)))
    chol_leaf_(torch.as_tensor(se_gram(40)))
    assert launch_counts() == before
