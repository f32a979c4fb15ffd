"""Port parity and packaging: the kernel build (`_build`: the nvcc command
for sm_90a over every source, the build root), the default device, the
float64 hyperparameters, importing the port without building or
importing JAX, the f32 Gram on the CPU, grouped atoms, partial parameter
overrides and the reference convention of `KernelFunction.kernel`,
against stpy_tpu on the CPU with the bars of tests/test_torch_port_gram.py
(which holds the cross and Gram entries of every kernel case).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stpy_tpu.kernels import KernelFunction as JaxKernel
from stpy_tpu_torch import KernelFunction as TorchKernel
from stpy_tpu_torch import _build
from stpy_tpu_torch.ops.gram import gram_plain, gram_scaled

from test_torch_port_gram import (
    GRAM_RTOL, REPO, _imported_modules, jax_kernel, points, rel_err,
    torch_kernel,
)
from torch_threads import one_torch_thread  # noqa: F401


def test_reference_convention_kernel_is_transposed(points):
    a, b = points
    got = torch_kernel("se+matern32").kernel(a, b)
    want = jax_kernel("se+matern32").kernel(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (23, 40)
    assert rel_err(got.numpy(), want) <= GRAM_RTOL


def test_partial_param_override_matches_jax(points):
    a, b = points
    jk, tk = jax_kernel("se*matern12"), torch_kernel("se*matern12")
    want = jk.eval_params({"1": {"gamma": jnp.asarray(0.3)}}, jnp.asarray(a),
                          jnp.asarray(b))
    got = tk.eval_params({"1": {"gamma": torch.tensor(0.3, dtype=torch.float64)}},
                         torch.as_tensor(a), torch.as_tensor(b))
    assert rel_err(got.numpy(), want) <= GRAM_RTOL


def test_grouped_atoms_match_jax(points):
    a, b = points
    jk = (JaxKernel(kernel_name="squared_exponential", gamma=0.5, d=3,
                    group=[0, 2])
          + JaxKernel(kernel_name="ard", ard_gamma=[0.4, 0.9, 1.3], d=3,
                      group=[1]))
    tk = (TorchKernel(kernel_name="squared_exponential", gamma=0.5, d=3,
                      group=[0, 2], dtype=torch.float64, device="cpu")
          + TorchKernel(kernel_name="ard", ard_gamma=[0.4, 0.9, 1.3], d=3,
                        group=[1], dtype=torch.float64, device="cpu"))
    want = jk.cross(jnp.asarray(a), jnp.asarray(b))
    assert rel_err(tk.cross(a, b).numpy(), want) <= GRAM_RTOL


def test_grouped_laplace_atom_matches_jax(points):
    a, b = points
    jk = (JaxKernel(kernel_name="laplace", gamma=0.6, d=3, group=[0, 2])
          * JaxKernel(kernel_name="matern", gamma=0.9, nu=2.5, d=3, group=[1]))
    tk = (TorchKernel(kernel_name="laplace", gamma=0.6, d=3, group=[0, 2],
                      dtype=torch.float64, device="cpu")
          * TorchKernel(kernel_name="matern", gamma=0.9, nu=2.5, d=3,
                        group=[1], dtype=torch.float64, device="cpu"))
    want = jk.cross(jnp.asarray(a), jnp.asarray(b))
    assert rel_err(tk.cross(a, b).numpy(), want) <= GRAM_RTOL


def test_hyperparameters_are_float64_on_the_kernel_device():
    tk = torch_kernel("ard*matern52", dtype=torch.float32)
    for params in tk.params_dict.values():
        for v in params.values():
            assert v.dtype == torch.float64 and v.device == tk.device
    x = np.zeros((4, 3))
    assert tk.cross(x, x).dtype == torch.float32


def test_no_device_means_the_card_and_never_the_cpu():
    """Without CUDA, a kernel or GP built with no `device` raises instead
    of quietly returning a CPU object."""
    from stpy_tpu_torch import GaussianProcess

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchKernel(d=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianProcess(d=3)
    assert TorchKernel(d=3, device="cpu").device == torch.device("cpu")


def test_default_device_resolves_to_cuda(monkeypatch):
    from stpy_tpu_torch.config import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_f32_gram_on_cpu_matches_f64(points):
    a, b = points
    xs = torch.as_tensor(a / 0.7, dtype=torch.float32)
    ys = torch.as_tensor(b / 0.7, dtype=torch.float32)
    got = gram_scaled(xs, ys, 1.0, "matern", 1.5)
    want = gram_plain(xs.double(), ys.double(), 1.0, "matern", 1.5)
    assert got.dtype == torch.float32
    # f32 rounding of the norm expansion, entries <= 1
    assert (got.double() - want).abs().max() <= 1e-5


def test_port_never_imports_jax():
    files = sorted((REPO / "stpy_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "optax", "stpy_tpu"), (
                path, mod)


def test_build_command_targets_sm90a_and_every_source():
    srcs = _build.sources()
    names = {src.name for src in srcs}
    assert names == {"gram.cu", "gram_df.cu", "gemv_df.cu", "gram_l1.cu",
                     "qform_df.cu", "gram_matvec.cu", "gram_matmat.cu",
                     "syrk_lower.cu", "chol_leaf.cu", "gram_df_stages.cu"}
    objs = [Path(f"{src.stem}.o") for src in srcs]
    for src, obj in zip(srcs, objs):
        cmd = _build.compile_command(src, obj)
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
        assert cmd[-1] == str(src) and cmd[cmd.index("-o") + 1] == str(obj)
    link = _build.link_command(objs, Path("out.so"))
    assert "-shared" in link and "arch=compute_90a,code=sm_90a" in link
    assert [c for c in link if c.endswith(".o")] == [str(o) for o in objs]
    # a header edit builds anew: headers are part of the library's hash
    assert {h.name for h in _build.headers()} == {"gram_shape.cuh",
                                                  "gram_df_entry.cuh",
                                                  "async_copy.cuh",
                                                  "wgmma_tf32.cuh",
                                                  "gram_tile.cuh"}
    assert _build.library_path().parent.parent == _build.BUILD_ROOT


def test_build_root_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    repo = Path(_build.__file__).resolve().parent.parent
    assert _build.BUILD_ROOT == repo / "build" / "stpy_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    installed = tmp_path / "site-packages" / "stpy_tpu_torch"
    assert _build.build_root(installed) == tmp_path / "cache" / "stpy_tpu_torch"


def test_importing_the_port_builds_nothing():
    assert _build._lib is None
