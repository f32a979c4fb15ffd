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
from stpy_tpu_torch import _build
from stpy_tpu_torch.ops.gram import gram_plain, gram_scaled

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


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


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
