"""A module fixture for the port's test modules: run torch on one intra-op
thread, and restore the count afterwards.

In a fresh process the first multi-threaded call of torch's CPU `exp` can
return part of its output at reduced accuracy (tools/torch_cpu_first_exp.py:
torch 2.13.0+cpu, six processes at a time, float64 entries off by up to
3.2e-9 in 4 of 240 fresh processes, float32 by up to 1.06e-4 in 3 of 60; no
single-threaded first call was off). Under `--dist loadfile` any port module
can be the first a test worker runs. A module takes the fixture with

    from torch_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
