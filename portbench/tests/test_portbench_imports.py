"""Nothing the benchmark runs loads JAX or the JAX package, the
reference loads nothing of the program, and nothing reads `benchmarks/`.
Top-level module names are compared whole: the port's name,
stpy_tpu_torch, begins with the JAX package's."""

import ast
import subprocess
import sys

from portbench.tests.tiny import PORTBENCH

CHECKOUT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "stpy_tpu"}

RUN_ALL = f"""
import importlib, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, {str(CHECKOUT)!r})
from portbench import harness, calibrate, run
from portbench.tests.tiny import tiny_bench
for p in Path({str(PORTBENCH)!r}).rglob("*.py"):
    rel = p.relative_to({str(CHECKOUT)!r}).with_suffix("")
    if "tests" not in rel.parts:
        importlib.import_module(".".join(rel.parts))
bench = harness.Bench(tiny_bench(Path(tempfile.mkdtemp())))
for w in bench.spec["workloads"]:
    for trace in (False, True):
        harness.run_cell(bench, w["name"], 5, 0.1, trace, "cpu",
                         time.perf_counter())
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.strip().splitlines()[-1].split())


def test_whole_runs_load_no_jax():
    loaded = _top_level_after(RUN_ALL)
    assert "stpy_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        f"import sys; sys.path.insert(0, {str(CHECKOUT)!r})\n"
        "import portbench.reference.posterior\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not loaded & (FORBIDDEN | {"stpy_tpu_torch"})


def _strings(path):
    """The string constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_nothing_names_the_jax_benchmarks_folder():
    for path in PORTBENCH.rglob("*.py"):
        if path.name == "test_portbench_imports.py":
            continue
        for s in _strings(path):
            assert "benchmarks" not in s, (path, s)
        tree = ast.parse(path.read_text())
        for n in ast.walk(tree):
            names = ([a.name for a in n.names] if isinstance(n, ast.Import)
                     else [n.module or ""] if isinstance(n, ast.ImportFrom)
                     else [])
            assert not {m.split(".")[0] for m in names} & FORBIDDEN, path
