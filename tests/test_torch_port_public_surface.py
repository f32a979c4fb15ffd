"""The port's public surface against the JAX package's: every public name of
every `stpy_tpu` module resolves on its counterpart module of
`stpy_tpu_torch`, as the same kind of object (a class for a class, a callable
for a function, a module for a module), or stands in DECLINED with its cause.

The JAX package is read with `ast`, so nothing here imports JAX. A module's
public names are its top-level functions, classes and assignments whose names
do not start with "_"; an `__init__.py` adds the names it imports. The
kernel wrappers were renamed in the port (`ops/pallas_*` → the files of
PORT_MODULES, as `PERF.md` §6 maps them), and a few names moved (MOVED).
"""

import ast
import importlib
import importlib.util
import inspect
import subprocess
import sys
import types
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT = REPO / "stpy_tpu"

# JAX module (dotted, under stpy_tpu) -> the port modules that hold its names
PORT_MODULES = {
    "ops.pallas_gram": ("ops.gram", "ops.gram_l1"),
    "ops.pallas_gram_df": ("ops.gram_df",),
    "ops.pallas_gemv_df": ("ops.gemv_df",),
    "ops.pallas_qform_df": ("ops.qform_df",),
    "ops.pallas_gram_matvec": ("ops.gram_matvec",),
    "ops.pallas_syrk": ("ops.syrk",),
    "ops.pallas_chol": ("ops.chol_leaf",),
}

# (JAX module, name) -> the port modules where the name lives now
MOVED = {
    ("ops.pallas_gram_matvec", "make_lazy_matvec_sharded"):
        ("parallel.lazy_kernel", "parallel"),
}

_NO_F64 = ("the TPU has no f64: the port evaluates in float64 and splits "
           "(ROADMAP Queue 1 item 13)")
# names the port declines, each with its cause (ROADMAP Queue 1 item 13).
# "*" declines a whole module; "Class.attr" an attribute of a class.
DECLINED = {
    ("ops", "gram"): "the name is the port's kernel module ops.gram; the "
                     "function is ops.gram.gram",
    ("ops", "gram_matvec"): "the name is the port's kernel module "
                            "ops.gram_matvec; the function is "
                            "ops.gram_matvec.gram_matvec",
    ("ops.pallas_gram_df", "DF_MAX_D"): "a VMEM bound: the TPU kernel falls "
                                        "back to HLO for d > 128; "
                                        "csrc/gram_df.cu takes any d",
    ("ops.pallas_syrk", "split_bf16"): "TPU v5e has no f32 MXU mode; "
                                       "syrk_lower.cu splits into TF32 "
                                       "halves (ops.syrk.split_tf32)",
    ("ops.compensated", "*"): _NO_F64,
    ("ops.df_interp", "*"): _NO_F64,
    ("ops.matern_df", "*"): _NO_F64,
    ("kernels.kernel_function", "KernelFunction.lo_limbs"):
        "the df tier's f32 lo-limb shadows of the hyperparameters; the "
        "port's hyperparameters and its double tier are float64",
    ("kernels.kernel_function", "KernelFunction.params_with_lo"):
        "the df tier's f32 lo-limb shadows of the hyperparameters; the "
        "port's hyperparameters and its double tier are float64",
    ("config", "as_array"): "a jnp array converter; the port's is "
                            "config.as_tensor(x, device, dtype)",
}


def jax_modules():
    """dotted name under stpy_tpu ("" for the package) -> source path."""
    out = {}
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(JAX_ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


MODULES = jax_modules()


def subpackage(mod):
    """The test case a JAX module belongs to: its first package, or
    "top level" for the package's own modules."""
    head = mod.split(".")[0]
    return head if head and (JAX_ROOT / head).is_dir() else "top level"


def kind_in(mod, name):
    """What `mod.name` is in the JAX package: "class", "function", "module"
    or "value", read from its source."""
    if f"{mod}.{name}".lstrip(".") in MODULES:
        return "module"
    for node in ast.parse(MODULES[mod].read_text()).body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return "class"
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return "function"
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            # an alias of a name of the same module has that name's kind
            if isinstance(node.value, ast.Name) and node.value.id != name:
                return kind_in(mod, node.value.id)
            return "value"
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if (alias.asname or alias.name) == name:
                    src = node.module.removeprefix("stpy_tpu").lstrip(".")
                    return kind_in(src, alias.name)
    return "value"


def public_names(mod):
    """The public names of a JAX module: its top-level definitions and, for
    a package, the names its __init__ imports."""
    path = MODULES[mod]
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return sorted(n for n in names if not n.startswith("_"))


def port_modules(mod, name):
    targets = MOVED.get((mod, name), PORT_MODULES.get(mod, (mod,)))
    return [importlib.import_module(f"stpy_tpu_torch.{t}".rstrip("."))
            for t in targets]


def resolves(obj, kind):
    if kind == "module":
        return isinstance(obj, types.ModuleType)
    if isinstance(obj, types.ModuleType):
        return False
    if kind == "class":
        return inspect.isclass(obj)
    return callable(obj) if kind == "function" else True


def port_has(mod, name):
    """Whether `name` of the JAX module `mod` resolves in the port as the
    same kind of object."""
    kind = kind_in(mod, name)
    for port in port_modules(mod, name):
        if hasattr(port, name) and resolves(getattr(port, name), kind):
            return True
    return False


def declined(mod, name):
    return (mod, name) in DECLINED or (mod, "*") in DECLINED


@pytest.mark.parametrize("package", sorted({subpackage(m) for m in MODULES}))
def test_every_public_name_resolves_in_the_port(package):
    missing = [f"{mod or 'stpy_tpu'}.{name}"
               for mod in MODULES if subpackage(mod) == package
               for name in public_names(mod)
               if not declined(mod, name) and not port_has(mod, name)]
    assert not missing, missing


def test_declined_names_are_still_missing():
    """A name the port gains leaves DECLINED."""
    for (mod, name), cause in DECLINED.items():
        assert cause
        if name == "*":
            assert importlib.util.find_spec(
                f"stpy_tpu_torch.{mod}") is None, mod
            continue
        if "." in name:
            cls, attr = name.split(".")
            assert public_names(mod).count(cls) == 1, (mod, cls)
            owner = getattr(port_modules(mod, cls)[0], cls)
            assert inspect.isclass(owner), (mod, cls)
            assert not hasattr(owner, attr), (mod, name)
            assert f"def {attr}(" in MODULES[mod].read_text(), (mod, name)
            continue
        assert name in public_names(mod), (mod, name)
        assert not port_has(mod, name), (mod, name)


def test_moved_names_resolve_where_the_map_says():
    for (mod, name), targets in MOVED.items():
        assert name in public_names(mod), (mod, name)
        assert not any(hasattr(m, name) for m in
                       (importlib.import_module(f"stpy_tpu_torch.{t}")
                        for t in PORT_MODULES.get(mod, (mod,)))), (mod, name)
        kind = kind_in(mod, name)
        for port in port_modules(mod, name):
            assert resolves(getattr(port, name, None), kind), (port, name)


@pytest.mark.parametrize("statement", [
    "import stpy_tpu_torch.ops.gram",
    "import stpy_tpu_torch.kernels",
    "import stpy_tpu_torch",
])
def test_first_import_in_a_fresh_interpreter(statement):
    """The ops package re-exports names of its kernel modules, which import
    it; each entry point must still import first."""
    probe = (f"{statement}\n"
             "from stpy_tpu_torch.ops import (gram_se, gram_matern, "
             "gram_laplace, make_lazy_matvec)\n"
             "import stpy_tpu_torch.ops as ops, types\n"
             "assert isinstance(ops.gram, types.ModuleType)\n")
    subprocess.run([sys.executable, "-c", probe], cwd=REPO, check=True,
                   timeout=120)
