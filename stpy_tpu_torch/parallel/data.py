"""Multi-process data loading: per-rank shards assembled into row-sharded
tensors, and a streamed sufficient-statistics fit over them.

Port of stpy_tpu/parallel/data.py on torch.distributed (parallel/mesh.py).
In the JAX package a "process" is a host, which loads only its own rows, and
`jax.make_array_from_process_local_data` stitches the per-process shards
into one global array over the mesh. In the port a process is a rank: each
rank loads only its own rows, and `host_sharded` makes them its block of a
row-sharded `DTensor` (rank i of the axis holds block i), so no row moves.
The only bytes that cross ranks are the (m, m) and (m, 1) sufficient
statistics all-reduced per batch of a streamed feature-GP fit, which is all
a primal fit needs. One rank is the degenerate layout, as one process is in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from stpy_tpu_torch.parallel.mesh import row_dtensor, sum_over


def host_sharded(local, mesh, axis: str = "tp"):
    """This rank's rows `local` (equal count on every rank) as its block of
    a row-sharded `DTensor` of shape (rows · ranks on the axis, ...), on
    the mesh's device, in `local`'s dtype."""
    dev = torch.device(mesh.device_type)
    t = (local.to(dev) if isinstance(local, torch.Tensor)
         else torch.as_tensor(np.ascontiguousarray(local), device=dev))
    return row_dtensor(t.contiguous(), mesh, axis)


class HostShardedLoader:
    """Iterate global (x, y) batches whose rows each rank loads itself.

    `local_source(start, stop)` returns this rank's rows [start, stop) of its
    OWN partition: each rank owns `n_global / world size` rows and is never
    asked for another's. A global batch of `batch_size` rows is
    `batch_size // world size` rows a rank, and comes out as row-sharded
    `DTensor`s (`host_sharded`). The final ragged batch is dropped, as in
    the JAX package (its shapes are static under jit)."""

    def __init__(self, local_source: Callable[[int, int], tuple],
                 n_local: int, batch_size: int, mesh, axis: str = "tp"):
        self.local_source = local_source
        self.n_local = n_local
        self.mesh = mesh
        self.axis = axis
        self.world = dist.get_world_size()
        self.local_batch = max(1, batch_size // self.world)
        self.n_batches = n_local // self.local_batch

    def __len__(self) -> int:
        return self.n_batches

    def __iter__(self) -> Iterator[tuple]:
        for b in range(self.n_batches):
            lo = b * self.local_batch
            out = self.local_source(lo, lo + self.local_batch)
            if not isinstance(out, tuple):
                out = (out,)
            yield tuple(host_sharded(a, self.mesh, self.axis) for a in out)


def streamed_feature_stats(embed_fn, loader: HostShardedLoader, m: int,
                           dtype=None):
    """V = ΣQᵀQ and b = ΣQᵀy over a sharded loader: per batch each rank
    embeds its own rows and forms its partial (m, m) and (m, 1) sums, which
    one all-reduce over the axis adds up (m² + m numbers a batch,
    whatever n). The multi-process face of
    `KernelizedFeatures.fit_gp_streamed`: the same statistics, rows never
    move. Returns (V, b), equal on every rank; `dtype` defaults to the
    embedding's."""
    V = b = None
    for xb, yb in loader:
        Q = embed_fn(xb.to_local())
        yl = yb.to_local().to(Q.dtype).reshape(Q.shape[0], -1)
        part = torch.cat([Q.T @ Q, Q.T @ yl], dim=1)
        part = sum_over(part.contiguous(), loader.mesh, loader.axis)
        if V is None:
            dt = dtype or Q.dtype
            V = torch.zeros((m, m), dtype=dt, device=Q.device)
            b = torch.zeros((m, 1), dtype=dt, device=Q.device)
        V += part[:, :m]
        b += part[:, m:]
    if V is None:
        raise ValueError("the loader yields no batch")
    return V, b


def fit_feature_gp_sharded(model, loader: HostShardedLoader):
    """Fit a `KernelizedFeatures` model from a sharded loader: streamed
    sufficient statistics over the mesh, then the primal state that
    `fit_gp_streamed` leaves (`theta_mean`, `mean_std`, `ucb` work). The
    model never sees the raw rows; `model.x` and `model.y` stay None."""
    V, b = streamed_feature_stats(model.embed, loader, model.m, model.dtype)
    V.diagonal().add_(model._ridge())
    model.V = V
    model.invV = model._inverse(V)
    model._Qty = b
    model.Q = None
    model.n = len(loader) * loader.local_batch * loader.world
    model.x = model.y = None
    model.dual = False
    model.data = True
    model.fitted = True
    model.to_add = []
    return model
