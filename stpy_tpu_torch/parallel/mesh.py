"""Device-mesh scale-out on torch.distributed: sharded Gram construction,
distributed evidence and restart farming.

Port of stpy_tpu/parallel/mesh.py. The JAX package is single-controller:
one process, a `Mesh` of devices, `NamedSharding` and `shard_map` with
`all_gather` / `psum`. The port is SPMD, PyTorch's own idiom: one process
(rank) per device, and every rank calls the same function with the same
global inputs. A mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the ranks; a row-sharded array is a `DTensor` with a `Shard(0)` placement on
the mesh dimension `axis` (the JAX `NamedSharding(mesh, P(axis))`), a
replicated one a `DTensor` placed `Replicate()` everywhere (`P()`). Inside,
the code works on each rank's local row block with explicit collectives on
`mesh.get_group(axis)`: an all-gather where JAX has
`all_gather(tiled=True)`, an all-reduce where it has `psum`, a broadcast
from the owner where it psums a masked block. Rank i of the axis holds the
global rows [i·n/p, (i + 1)·n/p).

Axes:
  'dp' — restart / chain farming (hyperparameter restarts, Langevin chains,
          BO candidates: batches that need no communication)
  'tp' — data sharding for large-n Gram / solve: each rank evaluates its
          (n/p, n) Gram tile against the gathered points (csrc/gram.cu on
          the card, through the kernel's own Gram)

Results that the JAX package returns replicated (evidence values, restart
outputs) come back as plain tensors, equal on every rank; results it leaves
row-sharded (`sharded_gram`) come back as row-sharded `DTensor`s.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._pytree import tree_map

from stpy_tpu_torch.config import resolve_device
from stpy_tpu_torch.linalg import chol_jittered, cho_solve, logdet_from_chol


def _start_group(device_type: str) -> None:
    """Start the default process group where the caller has not: from the
    launcher's environment (`torchrun`) when it names a world of several
    ranks, else a one-rank group on an in-process `HashStore`, which needs
    no port and no network. NCCL for the card, gloo for the CPU; never
    gloo on the card."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape=None, axis_names=("dp", "tp"), devices=None,
              device=None) -> DeviceMesh:
    """A `DeviceMesh` over the ranks; default shape (1, world size), all
    ranks on 'tp' (mesh.py:30-37). `devices` is a list of global ranks to
    lay out in `shape` (default: every rank, in order); `device` picks the
    device type (default: the card, see `config.resolve_device`).

    It joins the process group the caller started (`torchrun`,
    `init_process_group`). Where there is none, it starts one: the
    launcher's world when the environment names one, else a one-rank group
    (the degenerate layout that the JAX package's single process is). On
    the card each rank takes the device `LOCAL_RANK` names."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        _start_group(dev.type)
    world = dist.get_world_size()
    if shape is None:
        shape = (1, world if devices is None else len(devices))
    shape, axis_names = tuple(shape), tuple(axis_names)
    if devices is None:
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} does not cover the "
                             f"{world} ranks")
        return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    ranks = torch.as_tensor(np.asarray(devices).reshape(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axis_names)


# -- the collectives the mesh code is written in ------------------------------

def axis_info(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index on the axis, the axis' size)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


def gather_rows(local, mesh, axis):
    """All-gather of equal row blocks along dim 0, in axis-rank order
    (JAX's `all_gather(tiled=True)`); every rank gets the whole."""
    group, _, p = axis_info(mesh, axis)
    local = local.contiguous()
    out = torch.empty((p * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, local, group=group)
    return out


def sum_over(t, mesh, axis):
    """All-reduce (sum) over the axis (JAX's `psum`), in place where `t` is
    contiguous; returns the sum. A collective moves a tensor's storage as
    it lies, so a strided one (a triangular solve's column-major output)
    is made contiguous first."""
    group, _, _ = axis_info(mesh, axis)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def broadcast_from(t, owner: int, mesh, axis):
    """Broadcast of `t` from axis rank `owner` (in place where `t` is
    contiguous, see `sum_over`); returns the received tensor."""
    group, _, _ = axis_info(mesh, axis)
    t = t.contiguous()
    dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
    return t


def _placements(mesh, axis, shard: bool):
    out = [Replicate()] * mesh.ndim
    if shard:
        out[mesh.mesh_dim_names.index(axis)] = Shard(0)
    return out


def row_dtensor(local, mesh, axis, n_rows=None):
    """A row-sharded `DTensor` from this rank's equal row block (global
    rows p·local rows, or `n_rows` where the caller knows them)."""
    _, _, p = axis_info(mesh, axis)
    shape = ((p * local.shape[0] if n_rows is None else n_rows),) + \
        tuple(local.shape[1:])
    return DTensor.from_local(local, mesh, _placements(mesh, axis, True),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def rows_of(x, mesh, axis):
    """(this rank's rows, all rows, the first one's global index) of `x`:
    a row-sharded `DTensor` (its local block and its all-gather) or a
    global tensor that every rank holds (sliced; n must divide the axis,
    as a `shard_map` over it needs)."""
    _, rank, p = axis_info(mesh, axis)
    if isinstance(x, DTensor):
        local = x.to_local()
        return local, gather_rows(local, mesh, axis), rank * local.shape[0]
    n = x.shape[0]
    if n % p:
        raise ValueError(f"{n} rows do not split over the {p} ranks of "
                         f"axis {axis!r}")
    nl = n // p
    return x[rank * nl:(rank + 1) * nl], x, rank * nl


def full_of(x):
    """A global tensor from a `DTensor` (gathered) or as given."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard_rows(x, mesh, axis="tp"):
    """`x` (the same global tensor on every rank) as a row-sharded
    `DTensor` over `mesh[axis]`: each rank keeps its own rows."""
    local, _, _ = rows_of(x, mesh, axis)
    return row_dtensor(local.contiguous(), mesh, axis, x.shape[0])


def replicate(x, mesh):
    """`x` as a `DTensor` replicated on every rank of the mesh."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_gram(kernel_fn, x, mesh, axis="tp"):
    """Row-sharded Gram: each rank evaluates its (n/p, n) tile
    `kernel_fn(x_local, x_all)` against the gathered points (on the card a
    launch of the fused Gram kernel). The rows stay sharded: a `DTensor`
    of global shape (n, n)."""
    local, x_all, _ = rows_of(x, mesh, axis)
    return row_dtensor(kernel_fn(local, x_all), mesh, axis)


# -- the evidence over a mesh -----------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward hands each rank the
    cotangent of its own rows only. Every rank computes the same replicated
    loss after the gather, so each already holds the whole cotangent: the
    all-gather's own backward (a reduce-scatter) would sum p equal copies
    of it."""

    @staticmethod
    def forward(ctx, local, mesh, axis, row0):
        ctx.rows = (row0, local.shape[0])
        return gather_rows(local.detach(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        row0, nl = ctx.rows
        return grad[row0:row0 + nl], None, None, None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward all-reduces the cotangent: a parameter that
    reaches the loss through this rank's rows only gets the whole
    gradient, the sum of every rank's part."""

    @staticmethod
    def forward(ctx, v, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return v.view_as(v)

    @staticmethod
    def backward(ctx, grad):
        return sum_over(grad.clone(), ctx.mesh, ctx.axis), None, None


def _summed_params(params_dict, mesh, axis):
    return {k: {kk: (_SumGrad.apply(v, mesh, axis)
                     if isinstance(v, torch.Tensor) and v.requires_grad
                     else v) for kk, v in sub.items()}
            for k, sub in params_dict.items()}


def distributed_evidence(kernel, mesh, axis="tp"):
    """Negative log evidence over row-sharded data: `nll(params_dict, s, x,
    y)`, differentiable in the parameters and s.

    Each rank evaluates only its (n/p, n) Gram rows (the kernel's own Gram:
    on the card a launch of the fused kernel), and the rows are gathered
    for the Cholesky, which, as in the JAX package, runs on the whole K
    (replicated on every rank here). The gradient is the single-device
    one: the gather hands each rank the cotangent of its own rows
    (`_GatherRows`), and each parameter's gradient is summed over the
    ranks (`_SumGrad`), since a rank's rows carry only its part of it.
    As the port's exact evidence (`models.estimator.negative_log_evidence`),
    the gathered Gram is factored in float64 whatever its dtype, where the
    JAX package factors in the Gram's dtype (in f32 the conditioning of
    K + s²I biases the gradient). `x` and `y` are global tensors or
    row-sharded `DTensor`s; the value is a float64 scalar, equal on every
    rank."""

    def nll(params_dict, s, x, y):
        local, x_all, row0 = rows_of(x, mesh, axis)
        pd = _summed_params(params_dict, mesh, axis)
        K = _GatherRows.apply(kernel.eval_params(pd, local, x_all), mesh,
                              axis, row0).to(torch.float64)
        y = full_of(y).reshape(-1, 1).to(K.dtype)
        n = K.shape[0]
        K = 0.5 * (K + K.T) + (s * s) * torch.eye(n, dtype=K.dtype,
                                                  device=K.device)
        L = chol_jittered(K)
        alpha = cho_solve(L, y)
        return 0.5 * (y.T @ alpha)[0, 0] + 0.5 * logdet_from_chol(L)

    return nll


def restart_farm(fn, n_restarts, mesh, axis="dp"):
    """`torch.vmap(fn)` over a leading restart axis, the restarts split
    over `mesh[axis]`: each rank runs its slice of the batch and the
    results are gathered along the axis, equal on every rank. `call`
    takes the tuple of batched arguments (leading dimension
    `n_restarts`, which must divide the axis)."""
    vfn = torch.vmap(fn)

    def call(batched_args):
        _, rank, p = axis_info(mesh, axis)
        if n_restarts % p:
            raise ValueError(f"{n_restarts} restarts do not split over the "
                             f"{p} ranks of axis {axis!r}")
        k = n_restarts // p
        local = tree_map(lambda a: a[rank * k:(rank + 1) * k], batched_args)
        out = vfn(*local)
        return tree_map(lambda o: gather_rows(o, mesh, axis), out)

    return call
