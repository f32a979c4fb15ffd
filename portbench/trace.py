"""The reduction of a `torch.profiler` trace of the measured window.

What it keeps (`reduce`): the device's busy seconds as the union of all
device activity, the device seconds of each hand kernel of the program by
name, the device-to-host copies, the calls of each host event, the device
seconds of the kernels launched inside named host ops
(`Summary.op_device_s`), the top device kernels by time, and the longest
idle gaps between device activity grouped by the host event that was
running in the middle of each. A trace of the device alone has no host ops,
only the CUDA runtime's calls, which then name the gaps. It reads the profiler's raw
events (each device event names the host op that launched it), not its
event tree, which a CG window of a million events takes minutes to build.
The arithmetic is chip_smoke.profile_run's.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

import numpy as np

from portbench import plugins

TOP = 10
# idle gaps attributed to a host op one by one, the longest first; the rest
# are summed under one entry
LONGEST_GAPS = 2000
# the host op of a gap is looked for among this many that started before it
_LOOKBACK = 4096


@dataclass
class Summary:
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)     # hand kernel -> s
    op_counts: dict = field(default_factory=dict)   # host event -> count
    dtoh: int = 0                                   # device-to-host copies
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    # host ops (name, start ns, end ns) and, per device event, the start
    # of the host op that launched it (-1: none) and its seconds
    op_names: np.ndarray = None
    op_start: np.ndarray = None
    op_end: np.ndarray = None
    launched_at: np.ndarray = None
    device_s: np.ndarray = None

    def op_device_s(self, names) -> float:
        """Device seconds of the kernels launched inside any host op named
        in `names` (each kernel once, however the ops nest)."""
        if self.op_names is None or not len(self.device_s):
            return 0.0
        mask = np.isin(self.op_names, list(names))
        if not mask.any():
            return 0.0
        order = np.argsort(self.op_start[mask])
        starts, ends = self.op_start[mask][order], self.op_end[mask][order]
        ends = np.maximum.accumulate(ends)
        i = np.searchsorted(starts, self.launched_at, side="right") - 1
        inside = (i >= 0) & (self.launched_at >= 0)
        inside[inside] &= self.launched_at[inside] <= ends[i[inside]]
        return float(self.device_s[inside].sum())


def kernel_stems(pieces: plugins.Pieces) -> dict:
    """Device kernel -> the program's hand kernel it carries, from
    ``kernels/<hand kernel>.json`` (each a list of its device kernels:
    the kernel and its pre-passes and reductions); a new hand kernel is a
    new file."""
    stems = {}
    for name, p in pieces.data_files("kernels").items():
        stems.update(dict.fromkeys(json.loads(p.read_text()), name))
    return stems


def hand_kernel(name: str, stems: dict) -> str | None:
    """The program's hand kernel that a device kernel's name belongs to,
    by the whole identifier (demangled or mangled)."""
    for tok in re.split(r"[^A-Za-z0-9_]", name):
        tok = re.sub(r"^_Z\d+", "", tok)
        if tok in stems:
            return stems[tok]
    return None


def reduce(prof, window_s: float, stems: dict) -> Summary:
    """The summary of a profile of the window; `stems` as `kernel_stems`
    gives them."""
    from torch.autograd import DeviceType

    out = Summary(window_s=window_s)
    cpu, dev, op_start = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns(), e.name(),
                        e.linked_correlation_id()))
            continue
        s = e.start_ns()
        cpu.append((s, e.end_ns(), e.name()))
        if e.linked_correlation_id() == 0:
            op_start[e.correlation_id()] = s
            out.op_counts[e.name()] = out.op_counts.get(e.name(), 0) + 1
    dev.sort()
    cpu.sort()
    per_name, gaps = {}, []
    busy, reach = 0, None
    for start, end, name, _ in dev:
        if reach is not None and start > reach:
            gaps.append((start - reach, reach, start))
        busy += max(0, end - (start if reach is None else max(start, reach)))
        reach = end if reach is None else max(reach, end)
        per_name[name] = per_name.get(name, 0) + (end - start)
        out.dtoh += "DtoH" in name
    out.busy_s = busy * 1e-9
    for name, ns in per_name.items():
        k = hand_kernel(name, stems)
        if k is not None:
            out.kernels[k] = out.kernels.get(k, 0.0) + ns * 1e-9
    out.device_ops = [[name[:160], ns * 1e-9] for name, ns in
                      sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]]
    out.op_names = np.array([c[2] for c in cpu], dtype=object)
    out.op_start = np.array([c[0] for c in cpu], dtype=np.int64)
    out.op_end = np.array([c[1] for c in cpu], dtype=np.int64)
    out.launched_at = np.array([op_start.get(d[3], -1) if d[3] > 0 else -1
                                for d in dev], dtype=np.int64)
    out.device_s = np.array([(d[1] - d[0]) * 1e-9 for d in dev])
    out.idle_gaps = _idle_by_host(gaps, out)
    return out


def _idle_by_host(gaps, out: Summary) -> list:
    """The idle seconds of the LONGEST_GAPS longest gaps by the innermost
    host event that covered each gap's middle ("python" where none did),
    the rest summed as one entry; the TOP largest."""
    gaps.sort(reverse=True)
    by_op = {}
    starts, ends = out.op_start, out.op_end
    for length, a, b in gaps[:LONGEST_GAPS]:
        mid = (a + b) // 2
        name = "python"
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        for j in range(i, max(-1, i - _LOOKBACK), -1):
            if ends[j] >= mid:
                name = out.op_names[j]
                break
        by_op[name] = by_op.get(name, 0.0) + length * 1e-9
    rest = gaps[LONGEST_GAPS:]
    if rest:
        by_op[f"{len(rest)} gaps under {rest[0][0] * 1e-3:.1f} us"] = sum(
            g[0] for g in rest) * 1e-9
    return [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])
            [:TOP]]
