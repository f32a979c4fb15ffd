"""The benchmark harness of stpy_tpu_torch, driven by data.

`Bench` reads BENCHMARK.json and the data files it names under the
benchmark's folder: ``configs/<config>.json`` (a deployment: pool, split,
kernel, noise, and the system with its options), ``traffic/<mix>.json``
(the system options of the mix, the steps run once in set-up and the steps
of one call) and ``limits/<cell>.json`` (the numbers that decide
`correct`, their limits, and the control's precision). The code of each
piece is a file found by its name (portbench/plugins.py): the system that
builds the model, each step's op, the pool maker, the kernel families, the
judge of an op's outputs, and one reader per metric. A later cell adds
files and entries; no file here names a cell, a system or an op.

One run (`run_cell`): the configuration's pool, the model, the mix's set-up
steps and one warm call (set up ends there), then a closed loop of calls
with one caller for `seconds`, each call on a fresh split and timed to a
closing synchronize. With ``trace`` the loop runs under torch.profiler and
the per-layer metrics are read from its reduction (portbench/trace.py).
After the window the program's state is freed and a sample of the window's
calls, drawn from the seed, is held to the plain float64 reference by each
op's judge (portbench/reference/).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import data, plugins, trace

PORTBENCH = plugins.PORTBENCH
# calls of a window held to the reference, drawn from the seed
COMPARE_CALLS = 3


class Bench:
    """BENCHMARK.json and the data files it names, under `root`; the code
    of each piece is looked for under `root` first, then in portbench/."""

    def __init__(self, root: Path = PORTBENCH, bench_json: Path | None = None):
        self.root = Path(root)
        path = bench_json or self.root.parent / "BENCHMARK.json"
        self.spec = json.loads(Path(path).read_text())
        self.pieces = plugins.Pieces(self.root)

    def _json(self, *parts):
        return json.loads(self.root.joinpath(*parts).read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", (workload,))]

    def per_layer(self, workload: str) -> list[dict]:
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]

    def reader(self, metric: str, kind: str = "metrics"):
        return self.pieces.load(kind, metric).read

    def host_ops(self, workload: str) -> bool:
        """Whether a traced run records the host's ops: only where one of
        the cell's per-layer readers needs them (`HOST_OPS`), since their
        recording costs the host time that a host-paced loop shows as idle
        device time."""
        return any(getattr(self.pieces.load("metrics", m["name"]),
                           "HOST_OPS", False)
                   for m in self.per_layer(workload))


@dataclass
class Call:
    seconds: float
    state: torch.Tensor                 # the split generator's state
    fit_state: torch.Tensor             # that of the split last fitted on
    outputs: list                       # [(judge, kind, points, tensor)]
    status: dict


@dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    families: dict                      # kernel family -> its module
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)
    peak_bytes: int = 0                 # the process's, up to the window's end
    window_peak_bytes: int = 0
    launches: dict = field(default_factory=dict)
    profile: trace.Summary | None = None
    host_ops: bool = False              # the trace holds the host's ops
    warnings: list = field(default_factory=list)


def run_steps(ops, model, steps, x, y, xt) -> list:
    """One call: the steps' ops (`ops`: name -> module) on the model, in
    order; their outputs as (judge, kind, points, tensor), judged by the
    op's `JUDGE`."""
    outs = []
    for step in steps:
        op = ops[step["op"]]
        outs += [(op.JUDGE, *o) for o in op.run(model, x, y, xt, step)]
    return outs


class Cell:
    """One configuration under one traffic mix on one device: the pool, the
    splits and the model. `call` runs one call of the closed loop."""

    def __init__(self, bench: Bench, workload: str, seed: int, device):
        w = bench.workload(workload)
        self.workload = workload
        self.config = bench.config(w["config"])
        self.traffic = bench.traffic(w["traffic"])
        self.device = torch.device(device)
        self.seed = int(seed)
        pieces = bench.pieces
        self.x, self.y = data.make_pool(
            self.config, self.device,
            pieces.load("pools", self.config["data"]["pool"]))
        self.splits = data.Splits(self.config, seed, self.device)
        steps = self.traffic["steps"] + self.traffic.get("setup_steps", [])
        self.ops = {s["op"]: pieces.load("ops", s["op"]) for s in steps}
        self.judges = {op.JUDGE: pieces.load("reference", op.JUDGE)
                       for op in self.ops.values() if op.JUDGE}
        self.families = pieces.families(self.config)
        self.stems = trace.kernel_stems(pieces)
        sysconf = self.config["system"]
        self.system = pieces.load("systems", sysconf["name"])
        self.model = self.system.build(
            self.config, self.families,
            {**sysconf.get("options", {}),
             **self.traffic.get("system_options", {})}, self.device)
        self.fit_state = None
        self.records = {}               # what instrumented ops recorded

    def call(self, steps=None):
        """One call on a fresh split: (its state, the state of the split
        the model was last fitted on, the outputs). The mix's steps say
        whether it fits (an op's `FITS`), not what the program did."""
        steps = self.traffic["steps"] if steps is None else steps
        state, perm = self.splits.next()
        x, y, xt = data.split_inputs(self.config, self.x, self.y, perm)
        if any(self.ops[s["op"]].FITS for s in steps):
            self.fit_state = state
        return state, self.fit_state, run_steps(self.ops, self.model, steps,
                                                x, y, xt)

    def record(self, key, value):
        self.records.setdefault(key, []).append(value)

    def status(self) -> dict:
        """The system's status after a call, what instrumented ops recorded
        in it, and the ops the call ran."""
        st = self.system.status(self.model)
        st.update(self.records)
        self.records = {}
        st["ops"] = [s["op"] for s in self.traffic["steps"]]
        return st

    def instruments(self):
        """The instruments of the mix's ops (an op's `instrument`), for
        traced runs."""
        stack = contextlib.ExitStack()
        for name in dict.fromkeys(s["op"] for s in self.traffic["steps"]):
            op = self.ops[name]
            if hasattr(op, "instrument"):
                stack.enter_context(op.instrument(self.record))
        return stack

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _launch_counts() -> dict:
    from stpy_tpu_torch import ops

    return ops.launch_counts()


def failed(cell: Cell, call: Call) -> bool:
    """A call failed where its system reports so from its status (a failed
    factor, an unconverged solve) or where an output is not finite."""
    if cell.system.failed(call.status):
        return True
    return not all(bool(torch.isfinite(t).all())
                   for *_, t in call.outputs)


def measure(cell: Cell, seconds: float, t_start: float, profile: bool,
            min_calls: int = 1, host_ops: bool = True) -> Run:
    """The window: calls until `seconds` have passed (and at least
    `min_calls` ran), each timed to its closing synchronize. With
    `profile`, under torch.profiler: the device's activity, and the host's
    ops too where `host_ops`."""
    run = Run(cell.workload, cell.config, cell.traffic, cell.families)
    cuda = cell.device.type == "cuda"
    cell.sync()
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(cell.device)
        torch.cuda.reset_peak_memory_stats(cell.device)
    before = _launch_counts()
    prof = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        acts = ([ProfilerActivity.CPU] if host_ops or not cuda else []) + (
            [ProfilerActivity.CUDA] if cuda else [])
        prof = profiler(activities=acts)
    counting = cell.instruments() if profile else contextlib.nullcontext()
    with warnings.catch_warnings(record=True) as caught, prof as p, counting:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        while True:
            ts = time.perf_counter()
            state, fit_state, outs = cell.call()
            cell.sync()
            te = time.perf_counter()
            run.calls.append(Call(te - ts, state, fit_state, outs,
                                  cell.status()))
            if te - t0 >= seconds and len(run.calls) >= min_calls:
                break
        run.window_s = te - t0
    run.warnings = [str(w.message) for w in caught]
    after = _launch_counts()
    run.launches = {k: after[k] - before.get(k, 0) for k in after}
    if cuda:
        run.window_peak_bytes = torch.cuda.max_memory_allocated(cell.device)
        run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)
    if profile:
        run.profile = trace.reduce(p, run.window_s, cell.stems)
        run.host_ops = host_ops or not cuda
    return run


def picks(seed: int, ncalls: int) -> list[int]:
    """The calls of a window held to the reference, drawn from the seed."""
    rng = np.random.default_rng(data.stream_seed(seed, data.SAMPLE))
    k = min(COMPARE_CALLS, ncalls)
    return sorted(int(i) for i in rng.choice(ncalls, size=k, replace=False))


def compare(cell: Cell, calls: list, control: str | None = None):
    """The sampled calls' outputs against the float64 reference, each
    output by its op's judge (portbench/reference/<judge>.py) on the same
    inputs: the training rows of the split the model was fitted on and the
    call's own test points; with `control`, also the judge's control, the
    reference computed in that precision. Returns (program numbers,
    control numbers or None, picks)."""
    chosen = picks(cell.seed, len(calls))
    prog, ctrl = {}, ({} if control else None)

    def worst(into, numbers):
        for k, v in numbers.items():
            into[k] = max(into.get(k, 0.0), v)

    for i in chosen:
        call = calls[i]
        x, y, _ = data.split_inputs(cell.config, cell.x, cell.y,
                                    cell.splits.at(call.fit_state))
        _, _, xt = data.split_inputs(cell.config, cell.x, cell.y,
                                     cell.splits.at(call.state))
        by_judge = {}
        for judge, *out in call.outputs:
            by_judge.setdefault(judge, []).append(tuple(out))
        for judge, outs in by_judge.items():
            p, c = cell.judges[judge].judge(cell.config, cell.families, x, y,
                                            xt, outs, control)
            worst(prog, p)
            if control:
                worst(ctrl, c)
        del x, y, xt
    return prog, ctrl, chosen


def free_program(cell: Cell) -> None:
    """Drop the model and its buffers before the reference runs."""
    cell.model = None
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()


def setup(bench: Bench, workload: str, seed: int, device,
          log=None) -> Cell:
    """The cell, the mix's set-up steps and one warm call on its own
    shapes; with `log`, the seconds of each step."""
    t0 = time.perf_counter()
    cell = Cell(bench, workload, seed, device)
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if cell.traffic.get("setup_steps"):
            cell.call(cell.traffic["setup_steps"])
        cell.call()
    cell.sync()
    if log is not None:
        print(f"set-up: pool and model {t1 - t0:.3f} s, warm call "
              f"{time.perf_counter() - t1:.3f} s", file=log)
    return cell


def device_info(device, chips: int, run: Run) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(run.peak_bytes)
    if run.profile is not None:
        info["busy_s"] = run.profile.busy_s
        info["window_s"] = run.profile.window_s
    return info


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace_on: bool, device, t_start: float, log=sys.stderr) -> dict:
    """One run of a cell; returns the result line's object."""
    w = bench.workload(workload)
    print(f"set-up: to the harness {time.perf_counter() - t_start:.3f} s",
          file=log)
    cell = setup(bench, workload, seed, device, log)
    run = measure(cell, seconds, t_start, trace_on,
                  host_ops=bench.host_ops(workload))
    nfailed = sum(failed(cell, c) for c in run.calls)
    free_program(cell)
    if trace_on:
        metrics = {}
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        _log_counts(bench, run, log)
    else:
        metrics = {m["name"]: {"value": float(
            bench.reader(m["name"], "end_to_end")(run)), "unit": m["unit"]}
            for m in bench.end_to_end(workload)}
    if run.warnings:
        print(f"{len(run.warnings)} warnings in the window, the first: "
              f"{run.warnings[0]}", file=log)
    numbers, _, chosen = compare(cell, run.calls)
    numbers["failed_calls"] = nfailed
    limits = bench.limits(workload)["limits"]
    checks = {k: {"value": numbers.get(k, math.inf), "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"held to the reference: calls {chosen} of {len(run.calls)}",
          file=log)
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": nfailed, "metrics": metrics,
              "device": device_info(device, w["chips"], run)}
    if run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile.device_ops,
                               "idle_gaps": run.profile.idle_gaps}
    result["checks"] = checks
    return result


def json_safe(obj):
    """`obj` with every number that JSON cannot hold (inf, nan) as null."""
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


def _log_counts(bench: Bench, run: Run, log) -> None:
    """Each roofline's derived product count beside the program's launch
    counter, and the window's launches."""
    for m in bench.per_layer(run.workload):
        if not m["name"].endswith("_roofline"):
            continue
        kernel = m["name"][:-len("_roofline")]
        work = importlib.import_module(f"portbench.roofline.{kernel}")
        print(f"roofline {kernel}: derived products {work.products(run)}, "
              f"launches {run.launches.get(kernel, 0)}", file=log)
    print(f"launches in the window: "
          f"{ {k: v for k, v in run.launches.items() if v} }", file=log)
    ops = run.profile.op_counts
    print(f"traced {'host ops and ' if run.host_ops else ''}device: "
          f"device-to-host copies {run.profile.dtoh}, "
          f"aten::_local_scalar_dense {ops.get('aten::_local_scalar_dense')}, "
          f"host events {sum(ops.values())}", file=log)
