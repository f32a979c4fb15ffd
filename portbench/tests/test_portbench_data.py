"""The pool is the configuration's, the same in every run; the splits are
made from the seed, bit for bit."""

import json

import pytest
import torch

from portbench import data
from portbench.plugins import Pieces
from portbench.tests.tiny import PORTBENCH

CONFIGS = sorted(p.stem for p in (PORTBENCH / "configs").glob("*.json"))
BIG_SEED = 2 ** 31 + 12345


def _pool(c):
    return data.make_pool(c, "cpu", Pieces().load("pools",
                                                  c["data"]["pool"]))


def _config(name, rows=2000):
    c = json.loads((PORTBENCH / "configs" / f"{name}.json").read_text())
    c.update(pool_rows=rows, train_rows=rows * 64 // 100,
             test_rows=rows // 5)
    return c


@pytest.mark.parametrize("name", CONFIGS)
def test_pool_is_the_configurations(name):
    c = _config(name)
    x1, y1 = _pool(c)
    x2, y2 = _pool(c)
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert x1.shape == (c["pool_rows"], c["d"]) and x1.dtype == torch.float32
    assert float(x1.min()) >= c["data"]["x_low"]
    assert float(x1.max()) <= c["data"]["x_high"]
    # y = sin(3 x_0) + 0.1 eps: the residual is the noise
    r = y1 - torch.sin(c["data"]["y_frequency"] * x1[:, 0])
    assert abs(float(r.std()) - c["data"]["y_noise"]) < 0.01


@pytest.mark.parametrize("name", CONFIGS)
def test_splits_replay_from_their_state(name):
    c = _config(name)
    s = data.Splits(c, BIG_SEED, "cpu")
    drawn = [s.next() for _ in range(3)]
    assert not torch.equal(drawn[0][1], drawn[1][1])
    for state, perm in drawn:
        assert torch.equal(s.at(state), perm)
        assert torch.equal(torch.sort(perm).values,
                           torch.arange(c["pool_rows"]))
    again = data.Splits(c, BIG_SEED, "cpu")
    assert all(torch.equal(again.next()[1], p) for _, p in drawn)
    other = data.Splits(c, BIG_SEED + 1, "cpu")
    assert not torch.equal(other.next()[1], drawn[0][1])
    x, y = _pool(c)
    xtr, ytr, xte = data.split_inputs(c, x, y, drawn[0][1])
    assert xtr.shape == (c["train_rows"], c["d"])
    assert xte.shape == (c["test_rows"], c["d"])
    assert ytr.shape == (c["train_rows"],)


def test_stream_seeds_differ_and_fit_in_63_bits():
    seeds = {data.stream_seed(s, k) for s in (0, 1, BIG_SEED, 2 ** 40)
             for k in (data.POOL, data.SPLITS, data.SAMPLE)}
    assert len(seeds) == 12
    assert all(0 <= s < 2 ** 63 for s in seeds)
