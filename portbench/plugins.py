"""Pieces of the benchmark found by name: ``<root>/<kind>/<name>.py``.

Kinds: ``systems`` (build a configuration's model), ``ops`` (one step of
a call), ``pools`` (a configuration's rows), ``families`` (a kernel atom:
the port's name, the reference's correlation, the roofline's cost),
``reference`` (the judge of an op's outputs), ``end_to_end`` and
``metrics`` (one reader per metric); ``kernels`` holds data, the device
kernels of each hand kernel (portbench/trace.py)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent


class Pieces:
    """The pieces under `root`, then those of this folder."""

    def __init__(self, root: Path = PORTBENCH):
        self.roots = tuple(dict.fromkeys((Path(root).resolve(), PORTBENCH)))
        self._loaded = {}

    def path(self, kind: str, name: str) -> Path | None:
        """``<root>/<kind>/<name>.py`` in the first root that has it; for a
        metric split by the cells that report it (``call_s.cg``), the
        whole name's file, else its stem's (``call_s.py``)."""
        for stem in dict.fromkeys((name, name.split(".")[0])):
            for root in self.roots:
                p = root / kind / f"{stem}.py"
                if p.is_file():
                    return p
        return None

    def load(self, kind: str, name: str):
        """The module of piece `name` of `kind`; KeyError where none
        exists."""
        p = self.path(kind, name)
        if p is None:
            raise KeyError(f"no {kind}/{name}.py under "
                           f"{[str(r) for r in self.roots]}")
        if p not in self._loaded:
            key = f"portbench_{kind}_{p.stem}".replace(".", "_").replace(
                "-", "_")
            spec = importlib.util.spec_from_file_location(key, p)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._loaded[p] = module
        return self._loaded[p]

    def families(self, config: dict) -> dict:
        """Each kernel family the configuration's atoms name -> its
        module."""
        return {a["family"]: self.load("families", a["family"])
                for a in config["kernel"]}

    def data_files(self, kind: str, suffix: str = ".json") -> dict:
        """name -> path of every data file of `kind`, this folder's first,
        a root's own replacing it."""
        files = {}
        for root in reversed(self.roots):
            files.update((p.stem, p) for p in
                         sorted((root / kind).glob(f"*{suffix}")))
        return files
