"""The control of each cell comes out not `correct`: the plain reference
computed in the precision below the one the cell serves in
(``limits/<cell>.json``: "tf32" for the float32 tiers, "float32" for the
double-refined one), put in the program's place on the same calls'
inputs, fails at least one of the cell's limits.

On the card at the cell's own size on three seeds (the readings that set
the upper end of each limit, PERF.md); on the CPU at a size a test run
holds, where the control must still read above the program."""

import time

import pytest

from portbench import harness
from portbench.tests.tiny import tiny_bench

WORKLOADS = [w["name"] for w in harness.Bench().spec["workloads"]]
CARD_SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)
TEST_ROWS = {"pool_rows": 3000, "train_rows": 1920, "test_rows": 600}


def _readings(bench, workload, seed, device):
    cell = harness.setup(bench, workload, seed, device)
    run = harness.measure(cell, 0.1, time.perf_counter(), False,
                          min_calls=harness.COMPARE_CALLS)
    harness.free_program(cell)
    control = bench.limits(workload)["control"]
    return harness.compare(cell, run.calls, control)[:2]


def _fails(numbers, limits):
    return any(numbers.get(k, 0.0) > lim for k, lim in limits.items())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_above_the_program(tmp_path, workload):
    bench = harness.Bench(tiny_bench(tmp_path, TEST_ROWS))
    prog, ctrl = _readings(bench, workload, 2 ** 31 + 41, "cpu")
    limits = bench.limits(workload)["limits"]
    assert not _fails(prog, limits), prog
    assert set(ctrl) == set(prog)
    assert max(ctrl[k] / max(prog[k], 1e-300) for k in prog) > 3.0, (
        prog, ctrl)


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(card, workload):
    bench = harness.Bench()
    limits = bench.limits(workload)["limits"]
    for seed in CARD_SEEDS:
        prog, ctrl = _readings(bench, workload, seed, card)
        assert not _fails(prog, limits), (seed, prog)
        assert _fails(ctrl, limits), (seed, ctrl)
