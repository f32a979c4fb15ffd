"""The benchmark's inputs, made from the seed on the device.

One pool of rows per configuration (`make_pool`, by the maker that the
configuration's ``data["pool"]`` names under portbench/pools/), the same
for every run, as a deployment's data set is one; and one train/test split
of it per call (`Splits`), drawn from the run's seed: the same seed gives
the same sequence of splits, bit for bit, on one device type. A pool drawn
per seed would change the work with the seed, since the CG tier's
iterations follow the data: runs of different seeds would then differ far
more than two runs of one seed.
"""

from __future__ import annotations

import numpy as np
import torch

# stream numbers of `stream_seed`: one generator for the pool, one for the
# splits, one for the calls that are held to the reference
POOL, SPLITS, SAMPLE = 0, 1, 2
# the seed of every configuration's pool
POOL_SEED = 0


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's `--seed` (any
    whole number) and the stream's number."""
    words = np.random.SeedSequence([int(seed), stream]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def make_pool(config: dict, device, maker) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(x, y) of the configuration's pool on `device`, by `maker`, the pool
    maker its ``data["pool"]`` names (portbench/pools/), from one generator
    on the device seeded with POOL_SEED."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(POOL_SEED, POOL))
    return maker.make(config, g, device)


class Splits:
    """The sequence of per-call splits: each call is one permutation of the
    pool, its first `train_rows` rows the training set and the next
    `test_rows` the test points. `next` returns the generator state the
    permutation was drawn from, so `at` can draw it again."""

    def __init__(self, config: dict, seed: int, device):
        self.rows = config["pool_rows"]
        self.device = device
        self.g = torch.Generator(device=device)
        self.g.manual_seed(stream_seed(seed, SPLITS))

    def next(self) -> tuple[torch.Tensor, torch.Tensor]:
        state = self.g.get_state()
        return state, torch.randperm(self.rows, generator=self.g,
                                     device=self.device)

    def at(self, state: torch.Tensor) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.set_state(state)
        return torch.randperm(self.rows, generator=g, device=self.device)


def split_inputs(config: dict, x: torch.Tensor, y: torch.Tensor,
                 perm: torch.Tensor):
    """(x_train, y_train, x_test) of one call: an index gather on the
    pool's device."""
    ntr, nte = config["train_rows"], config["test_rows"]
    tr, te = perm[:ntr], perm[ntr:ntr + nte]
    return x[tr], y[tr], x[te]


def points(step: dict, xt: torch.Tensor) -> int:
    """The test points a step reads: its ``points``, or all of them."""
    p = step.get("points", "all")
    return xt.shape[0] if p == "all" else int(p)
