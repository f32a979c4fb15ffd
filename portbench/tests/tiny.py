"""A copy of the benchmark's data files with the pools cut to a size the
CPU runs in a second, for tests that drive whole runs. The code of each
piece is found in portbench/ itself (portbench/plugins.py)."""

import json
import shutil
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
TINY_ROWS = {"pool_rows": 1000, "train_rows": 640, "test_rows": 200}


def tiny_bench(tmp: Path, rows=TINY_ROWS) -> Path:
    """`tmp`/portbench with every data folder and BENCHMARK.json copied,
    each configuration's pool and split set to `rows`. Returns the folder."""
    root = tmp / "portbench"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(PORTBENCH / sub, root / sub)
    for p in (root / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(rows)
        p.write_text(json.dumps(c))
    shutil.copy(PORTBENCH.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return root
