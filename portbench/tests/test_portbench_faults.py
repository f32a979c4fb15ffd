"""A run whose timed path is broken underneath comes out not `correct`.

Each cell's whole run (set-up, window, comparison) at the CPU's size, the
look for a card skipped, with one fault planted in the call the window
drives: the model's state left unchanged after the first fit (each later
call serves the first call's posterior), half of the training rows left
out of the fit, and one answer altered where it is produced. The cells run
on one card, so no exchange between cards can be left out."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny_bench

WORKLOADS = [w["name"] for w in harness.Bench().spec["workloads"]]


def harness_ops():
    from portbench.plugins import Pieces

    return Pieces()


def stale(steps_fn):
    fitted = {}

    def run_steps(ops, model, steps, x, y, xt):
        if id(model) not in fitted:
            fitted[id(model)] = True
            return steps_fn(ops, model, steps, x, y, xt)
        outs = []
        for step in steps:
            if step["op"] == "fit":
                continue
            if step["op"] == "fit_predict":
                step = {**step, "op": "mean_std"}
                ops = {**ops, "mean_std": harness_ops().load("ops",
                                                             "mean_std")}
            outs += steps_fn(ops, model, [step], x, y, xt)
        return outs

    return run_steps


def half_batch(steps_fn):
    def run_steps(ops, model, steps, x, y, xt):
        h = x.shape[0] // 2
        return steps_fn(ops, model, steps, x[:h], y[:h], xt)

    return run_steps


def altered(steps_fn):
    def run_steps(ops, model, steps, x, y, xt):
        outs = steps_fn(ops, model, steps, x, y, xt)
        judge, kind, p, t = outs[-1]
        t = t.clone()
        t.view(-1)[p // 2] += 1e-2 * float(t.abs().max())
        return outs[:-1] + [(judge, kind, p, t)]

    return run_steps


def _run(tmp_path, workload):
    bench = harness.Bench(tiny_bench(tmp_path))
    return harness.run_cell(bench, workload, 2 ** 31 + 3, 0.3, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tmp_path, workload):
    res = _run(tmp_path, workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [stale, half_batch, altered])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(tmp_path, monkeypatch, workload, fault):
    monkeypatch.setattr(harness, "run_steps", fault(harness.run_steps))
    torch.manual_seed(0)
    res = _run(tmp_path, workload)
    assert not res["correct"], res["checks"]
