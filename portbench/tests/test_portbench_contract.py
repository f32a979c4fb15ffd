"""BENCHMARK.json keeps to the contract's shape, and a run's last line
carries the keys that are read from it."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.plugins import Pieces
from portbench.tests.tiny import PORTBENCH, tiny_bench

CHECKOUT = PORTBENCH.parent
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        f = json.loads((CHECKOUT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert c["file"] == f"{SPEC['paths'][0]}/configs/{c['name']}.json"
    names = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PORTBENCH / "limits" / f"{w['name']}.json").is_file()
        names.add(w["name"])
    assert len(names) == len(SPEC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(SPEC["workloads"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower",
                                                               "higher")
        assert Pieces().path("end_to_end", m["name"]) is not None
        assert set(m.get("workloads", names)) <= names
    for m in SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        assert Pieces().path("metrics", m["name"]) is not None
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  harness.Bench().end_to_end(w)}, (m, w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in names:
        bench = harness.Bench()
        reported = {m["name"] for m in bench.end_to_end(w)}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer(w)


def test_result_line_parses(tmp_path):
    root = tiny_bench(tmp_path)
    bench = harness.Bench(root)
    w = SPEC["workloads"][0]["name"]
    for trace in (False, True):
        res = harness.run_cell(bench, w, 2 ** 31 + 99, 0.2, trace, "cpu",
                               time.perf_counter())
        line = json.loads(json.dumps(harness.json_safe(res),
                                     allow_nan=False))
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(line)
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["attempted"] >= 1
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(line["metrics"]) == {
                m["name"] for m in bench.end_to_end(w)}


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits nonzero and prints nothing on
    standard output; so it does in a folder that holds only the benchmark's
    own files (no program beside it)."""
    w = SPEC["workloads"][0]["name"]
    args = ["--workload", w, "--seed", "1", "--seconds", "1", "--trace", "0"]
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, *SPEC["command"][1:], *args],
                         cwd=CHECKOUT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    alone = tmp_path / "alone"
    shutil.copytree(PORTBENCH, alone / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", alone / "BENCHMARK.json")
    out = subprocess.run([sys.executable, *SPEC["command"][1:], *args],
                         cwd=alone, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_short_run_on_the_card(card):
    w = SPEC["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, *SPEC["command"][1:], "--workload", w, "--seed",
         "77", "--seconds", "2", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
