"""Structured metrics, timing and tracing: the port of
stpy_tpu/utils/metrics.py.

`time_jitted` times a call whose result lies on the card by CUDA events
after a synchronize, and one on the CPU by the host clock; `trace` writes
a `torch.profiler` Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


@dataclass
class FitMetrics:
    name: str = ""
    wall_time_s: float = 0.0
    compile_time_s: float = 0.0
    iterations: int = 0
    nll: float = float("nan")
    extra: dict = field(default_factory=dict)

    def as_dict(self):
        d = {
            "name": self.name,
            "wall_time_s": round(self.wall_time_s, 6),
            "compile_time_s": round(self.compile_time_s, 6),
            "iterations": self.iterations,
            "nll": self.nll,
        }
        d.update(self.extra)
        return d


@contextlib.contextmanager
def timed(metrics: FitMetrics):
    t0 = time.perf_counter()
    yield
    metrics.wall_time_s = time.perf_counter() - t0


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


def time_jitted(fn, *args, reps=3):
    """(first-call time, median time of `reps` further calls) in seconds.
    The first call is timed by the host clock up to a synchronize; when
    its result lies on the card each further call is timed by CUDA events
    recorded around it after a synchronize, else by the host clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    card = _on_card(out)
    if card:
        torch.cuda.synchronize()
    compile_time = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        if card:
            torch.cuda.synchronize()
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return compile_time, times[len(times) // 2]


@contextlib.contextmanager
def trace(path="torch-trace.json"):
    """A `torch.profiler` trace of the block (CPU, and CUDA where there is
    a card), written to `path` as a Chrome trace (view with perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


def flops_achieved(flops: int, seconds: float) -> float:
    return flops / max(seconds, 1e-12)
