"""A configuration, a traffic mix, a cell's limits and every piece of code
they need are added as new files and entries alone: the harness finds each
by its name. The throwaway cell below brings its own pool maker, kernel
family, system, op, judge, end-to-end metric and per-layer metric from a
temporary folder, and a mix that fits once in set-up and then serves
predict-only calls."""

import json
import time

from portbench import harness

CONFIG = {
    "name": "throwaway", "source": "a test", "pool_rows": 600, "d": 3,
    "train_rows": 400, "test_rows": 100,
    "data": {"pool": "uniform_cosine", "y_noise": 0.05},
    "kernel": [{"family": "se_too", "gamma": 0.7, "kappa": 1.5}], "s": 0.05,
    "system": {"name": "double_gp", "options": {}},
    "reduced": [], "assumed": {}}
# fitted once in set-up; each call reads the posterior at fresh points
SERVE = {"system_options": {}, "setup_steps": [{"op": "fit"}],
         "steps": [{"op": "mean_sd", "points": 30}]}
FILES = {
    "pools/uniform_cosine.py": '''
import torch
def make(config, g, device):
    n, d = config["pool_rows"], config["d"]
    x = torch.rand((n, d), generator=g, device=device)
    eps = torch.randn((n,), generator=g, device=device)
    return x, torch.cos(3 * x[:, 0]) + config["data"]["y_noise"] * eps
''',
    "families/se_too.py": '''
from portbench.roofline.bounds import shape_cost
PORT = "squared_exponential"
def correlation(sq, atom):
    return sq.mul_(-0.5).exp_()
def cost(atom, shape="k"):
    return shape_cost("se", None, shape)
''',
    "systems/double_gp.py": '''
from portbench.families import port_kernel
def build(config, families, options, device):
    from stpy_tpu_torch.models.exact_gp import GaussianProcess
    return GaussianProcess(kernel=port_kernel(config, families, device),
                           s=config["s"], precision="double")
def status(model):
    return dict(model.fit_status or {})
def failed(status):
    return False
''',
    "ops/mean_sd.py": '''
FITS = False
JUDGE = "sd_only"
def run(model, x, y, xt, step):
    p = int(step["points"])
    return [("sd", p, model.mean_std(xt[:p])[1])]
''',
    "reference/sd_only.py": '''
from portbench.reference.posterior import posterior
def judge(config, families, x, y, xt, outputs, control=None):
    (_, p, t), = outputs
    def err(prec):
        return posterior(x, y, xt, config["kernel"], config["s"], prec, 0, p,
                         families)[1]
    ref = err("float64")
    e = lambda v: float(((v.reshape(-1).double() - ref) / ref).abs().max())
    return {"sd_err": e(t)}, ({"sd_err": e(err(control))} if control
                              else None)
''',
    "end_to_end/calls_per_s.py": '''
def read(run):
    return len(run.calls) / run.window_s
''',
    "metrics/calls_seen.py": '''
def read(run):
    return float(len(run.calls)) if run.calls else None
''',
}


def test_a_new_cell_is_files_alone(tmp_path):
    root = tmp_path / "bench"
    for rel, text in FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir()
    (root / "configs" / "throwaway.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "serve30.json").write_text(json.dumps(SERVE))
    (root / "limits" / "throwaway.serve30.json").write_text(json.dumps(
        {"control": "float32", "limits": {"sd_err": 1e-2,
                                           "failed_calls": 0}}))
    w = "throwaway.serve30"
    spec = {"command": ["python3", "bench/run.py"], "paths": ["bench"],
            "run_seconds": 1, "configs": [], "workloads": [
                {"name": w, "config": "throwaway", "traffic": "serve30",
                 "chips": 1, "why": "a test"}],
            "end_to_end": [{"name": "setup_s", "unit": "s",
                            "better": "lower", "bound": 0.25,
                            "source": "host_clock"},
                           {"name": "calls_per_s", "unit": "calls/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock"}],
            "per_layer": [{"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "models", "moves": "calls_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    plain = harness.run_cell(bench, w, 11, 0.2, False, "cpu",
                             time.perf_counter())
    assert set(plain["metrics"]) == {"setup_s", "calls_per_s"}
    assert plain["correct"], plain["checks"]
    traced = harness.run_cell(bench, w, 11, 0.2, True, "cpu",
                              time.perf_counter())
    assert traced["metrics"]["calls_seen"]["value"] == traced["attempted"]
    assert set(traced["checks"]) == {"sd_err", "failed_calls"}

    # every call is held to the split the model was fitted on in set-up;
    # held to its own split's rows instead, the same outputs fail
    cell = harness.setup(bench, w, 11, "cpu")
    run = harness.measure(cell, 0.1, time.perf_counter(), False, 3)
    assert all(torch_equal(c.fit_state, run.calls[0].fit_state)
               for c in run.calls)
    assert not any(torch_equal(c.state, c.fit_state) for c in run.calls)
    prog = harness.compare(cell, run.calls)[0]
    for c in run.calls:
        c.fit_state = c.state
    wrong = harness.compare(cell, run.calls)[0]
    assert prog["sd_err"] < 1e-2 < wrong["sd_err"], (prog, wrong)


def torch_equal(a, b):
    import torch

    return torch.equal(a, b)
