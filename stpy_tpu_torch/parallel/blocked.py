"""Distributed dense exact GP: blocked Cholesky and blocked triangular
solves of a row-sharded matrix over a device mesh.

Port of stpy_tpu/parallel/blocked.py on torch.distributed (parallel/mesh.py:
one rank per device, every rank calling with the same global inputs; rank i
of ``mesh[axis]`` holds the global rows [i·n/p, (i + 1)·n/p)). The JAX
package writes a masked right-looking factorization on the global array and
lets GSPMD insert the collectives, or steps a `shard_map` panel by panel;
the port writes the panel loop with its collectives explicit. Per panel j
of width nb:

  * the (nb, nb) diagonal block is broadcast from the rank that owns its
    rows (an all-reduce of the masked rows where the block straddles two
    ranks) and factored redundantly on every rank (nb³ is small);
  * each rank forms its rows of the panel W = C·Ljj⁻ᵀ, zero at and above
    the diagonal block (a triangular solve, row-local);
  * one all-gather of that panel (n·nb floats a step, n² over the
    factorization: one ring pass of the matrix), and each rank updates its
    rows of the columns to the right, strip by strip, with a GEMM.

Three factorizations (`DistributedExactGP(factorization=...)`):

  * "panels", the default and the capacity path: each rank holds its rows
    of the k = n/nb column strips in one (n/p, n) buffer and updates them in
    place, so its peak is n²/p plus one (n, nb) panel (the JAX version's
    donated strips);
  * "masked": the same steps on a separate (n/p, n) row block of K and of L
    (`blocked_cholesky` over a row-sharded `DTensor`), the JAX package's
    GSPMD layout;
  * "rec": the matrix is gathered to every rank and factored there by
    `linalg.chol_recursive` (n³/3 operations), of which each rank keeps its
    rows. The JAX GSPMD recursion replicates about n² per device too
    (blocked.py:393-395); this is the same memory said plainly.

The panel's trailing update is a plain GEMM outside any Pallas kernel, so it
is `torch.addmm` here; the Gram rows (csrc/gram.cu on the card) are the
kernel's own Gram. The posterior's triangular solves run panel by panel
against the row-sharded factor with the right-hand side replicated
(`solve_strips_sharded`): O(n·t + n²/p) per rank.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from stpy_tpu_torch.config import as_tensor
from stpy_tpu_torch.linalg import _cholesky, chol_recursive
from stpy_tpu_torch.parallel.mesh import (
    _placements,
    axis_info,
    broadcast_from,
    gather_rows,
    make_mesh,
    row_dtensor,
    rows_of,
    sum_over,
)


def _lower_solve(Ljj, B):
    return torch.linalg.solve_triangular(Ljj, B, upper=False)


def blocked_cholesky(K, nb: int = 1024):
    """Lower Cholesky factor of SPD K by the masked right-looking block
    factorization: all heavy work is (n, nb) × (nb, n) GEMMs. On a global
    tensor it runs on one device; on a row-sharded `DTensor` each rank
    updates its own rows (the "masked" factorization) and L comes back
    row-sharded. Requires n % nb == 0 (`chol_sharded` pads)."""
    n = K.shape[0]
    if n % nb:
        raise ValueError("blocked_cholesky requires n divisible by nb")
    if isinstance(K, DTensor):
        mesh = K.device_mesh
        axis = _shard_axis(K)
        local = K.to_local()
        _, rank, _ = axis_info(mesh, axis)
        L = _masked_rows(local, rank * local.shape[0], nb, mesh, axis)
        return row_dtensor(L, mesh, axis, n)
    A = K.clone()
    L = torch.zeros_like(K)
    rows = torch.arange(n, device=K.device)
    for j in range(n // nb):
        c0, c1 = j * nb, (j + 1) * nb
        C = A[:, c0:c1]
        Ljj = _cholesky(C[c0:c1])
        W = _lower_solve(Ljj, C.T).T
        Wb = torch.where((rows >= c1)[:, None], W, torch.zeros_like(W))
        L[:, c0:c1] = Wb
        L[c0:c1, c0:c1] = Ljj
        A[c1:, c1:].addmm_(Wb[c1:], Wb[c1:].T, alpha=-1.0)
    return L


def _shard_axis(K):
    """The name of the mesh dimension on which a `DTensor` is row-sharded."""
    for name, pl in zip(K.device_mesh.mesh_dim_names, K.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            return name
    raise ValueError("a row-sharded DTensor (Shard(0)) is needed")


def _diag_block(C, c0, nbe, row0, mesh, axis):
    """Rows [c0, c0 + nbe) of a row-sharded column panel C, on every rank:
    a broadcast from the rank that owns them all, or an all-reduce of the
    masked rows where they straddle two ranks."""
    _, rank, _ = axis_info(mesh, axis)
    nl = C.shape[0]
    owner = c0 // nl
    if (c0 + nbe - 1) // nl == owner:
        blk = (C[c0 - row0:c0 - row0 + nbe].contiguous() if rank == owner
               else C.new_empty((nbe, C.shape[1])))
        return broadcast_from(blk, owner, mesh, axis)
    blk = C.new_zeros((nbe, C.shape[1]))
    lo, hi = max(c0, row0), min(c0 + nbe, row0 + nl)
    if lo < hi:
        blk[lo - c0:hi - c0] = C[lo - row0:hi - row0]
    return sum_over(blk, mesh, axis)


def _factor_panel(C, c0, row0, mesh, axis):
    """(this rank's rows of the finished L column, its rows of the masked
    panel Wb, the gathered Wb) for the panel C = A[:, c0:c0 + nbe]."""
    nl, nbe = C.shape
    Ljj = _cholesky(_diag_block(C, c0, nbe, row0, mesh, axis))
    W = _lower_solve(Ljj, C.T).T
    grows = row0 + torch.arange(nl, device=C.device)
    Wb = torch.where((grows >= c0 + nbe)[:, None], W, torch.zeros_like(W))
    Lcol = Wb.clone()
    lo, hi = max(c0, row0), min(c0 + nbe, row0 + nl)
    if lo < hi:
        Lcol[lo - row0:hi - row0] = Ljj[lo - c0:hi - c0]
    return Lcol, Wb, gather_rows(Wb, mesh, axis)


def _masked_rows(local, row0, nb, mesh, axis):
    """This rank's rows of L for its rows `local` of K (the "masked"
    factorization: a separate row block of K updated and of L written)."""
    A = local.clone()
    L = torch.zeros_like(local)
    n = local.shape[1]
    for c0 in range(0, n, nb):
        Lcol, Wb, W_full = _factor_panel(A[:, c0:c0 + nb], c0, row0, mesh,
                                         axis)
        L[:, c0:c0 + nb] = Lcol
        for r0 in range(c0 + nb, n, nb):
            A[:, r0:r0 + nb].addmm_(Wb, W_full[r0:r0 + nb].T, alpha=-1.0)
    return L


def _panel_size(nl: int, nb: int) -> int:
    """Largest panel width ≤ nb that divides the per-rank row count."""
    q = -(-nl // nb)
    while nl % q:
        q += 1
    return nl // q


def panel_step_strips(mesh, axis, np_: int, nbe: int):
    """(step, k): one in-place panel step of the strip-held right-looking
    Cholesky, and the number of panels k = np_/nbe. `strips` is this rank's
    list of k (np_/p, nbe) column strips (separate tensors, or views into one
    row block); `step(strips, j)` turns strip j into the finished L column
    and updates the strips to its right, and returns the list. The
    diagonal block comes from its owner (nbe divides the per-rank rows), the
    panel is all-gathered once; per-rank peak n²/p + one (np_, nbe) panel."""
    _, rank, p = axis_info(mesh, axis)
    nl = np_ // p
    if nl % nbe:
        raise ValueError(f"panel width {nbe} does not divide the {nl} rows "
                         "of a rank")
    k_panels = np_ // nbe

    def step(strips, j):
        c0 = j * nbe
        Lcol, Wb, W_full = _factor_panel(strips[j], c0, rank * nl, mesh, axis)
        for r in range(j + 1, k_panels):
            strips[r].addmm_(Wb, W_full[r * nbe:(r + 1) * nbe].T, alpha=-1.0)
        strips[j].copy_(Lcol)
        return strips

    return step, k_panels


def solve_strips_sharded(mesh, axis, np_: int, nbe: int,
                         transpose: bool = False):
    """Panel-sequential triangular solve against a strip-held factor:
    L X = B (or Lᵀ X = B), B and X replicated (np_, t), the factor's column
    strips row-sharded as `panel_step_strips` leaves them. O(n·t + n²/p)
    per rank, no gathered factor.

    Forward: X_j = Ljj⁻¹(B_j − Σ_{r<j} L[j-block, r-block] X_r), computed by
    the rank that owns the panel's rows and broadcast. Backward: the
    contraction Σ L[:, j-block]ᵀ X is a partial GEMM on each rank's rows,
    all-reduced; the diagonal block comes from its owner, and every rank
    solves."""
    _, rank, p = axis_info(mesh, axis)
    nl = np_ // p
    k_panels = np_ // nbe
    row0 = rank * nl

    def forward(S, B):
        X = B.new_zeros(B.shape)
        for j in range(k_panels):
            c0 = j * nbe
            owner = c0 // nl
            if rank == owner:
                off = c0 - row0
                acc = B.new_zeros((nbe, B.shape[1]))
                for r in range(j):
                    acc += S[r][off:off + nbe] @ X[r * nbe:(r + 1) * nbe]
                Xj = _lower_solve(S[j][off:off + nbe], B[c0:c0 + nbe] - acc)
            else:
                Xj = B.new_empty((nbe, B.shape[1]))
            X[c0:c0 + nbe] = broadcast_from(Xj, owner, mesh, axis)
        return X

    def backward(S, B):
        X = B.new_zeros(B.shape)
        for j in reversed(range(k_panels)):
            c0 = j * nbe
            col = S[j]
            acc = sum_over(col.T @ X[row0:row0 + nl], mesh, axis)
            Ljj = _diag_block(col, c0, nbe, row0, mesh, axis)
            X[c0:c0 + nbe] = torch.linalg.solve_triangular(
                Ljj.T, B[c0:c0 + nbe] - acc, upper=True)
        return X

    return backward if transpose else forward


def _strips(rows_block, nbe):
    """The column strips of a (nl, np_) row block, as views."""
    return [rows_block[:, c0:c0 + nbe]
            for c0 in range(0, rows_block.shape[1], nbe)]


def _pad_spd(K, nb: int):
    """(K padded to a multiple of nb with a unit diagonal, n, pad)."""
    n = K.shape[0]
    pad = (-n) % nb
    if pad == 0:
        return K, n, 0
    Kp = torch.zeros((n + pad, n + pad), dtype=K.dtype, device=K.device)
    Kp[:n, :n] = K
    Kp.diagonal()[n:] = 1.0
    return Kp, n, pad


def _step(nb, p):
    return nb * p // math.gcd(nb, p)


def chol_sharded(K, mesh, axis: str = "tp", nb: int = 1024):
    """Cholesky of an SPD matrix row-sharded over `mesh[axis]` (a global
    tensor on every rank, or a row-sharded `DTensor`), by the masked
    factorization. Returns L row-sharded (a `DTensor`). Pads to a multiple
    of nb and of the axis (unit diagonal), so any n works; a padded factor
    is cut and laid out again through one gather."""
    _, rank, p = axis_info(mesh, axis)
    if isinstance(K, DTensor):
        K = K.full_tensor()
    Kp, n, pad = _pad_spd(K, _step(nb, p))
    local, _, row0 = rows_of(Kp, mesh, axis)
    L = _masked_rows(local, row0, nb, mesh, axis)
    if not pad:
        return row_dtensor(L, mesh, axis, n)
    # the padded factor's leading block, laid out again in `DTensor`'s
    # uneven row split
    L = gather_rows(L, mesh, axis)[:n, :n].contiguous()
    return distribute_tensor(L, mesh, _placements(mesh, axis, True),
                             src_data_rank=None)


def chol_sharded_rec(K, mesh, axis: str = "tp", nb: int = 1024,
                     precision=None):
    """Cholesky of an SPD matrix over `mesh[axis]` by divide and conquer
    (`linalg.chol_recursive`, n³/3 operations): the matrix is gathered to
    every rank, factored there, and L comes back row-sharded. Its memory is
    n² a rank, as the JAX package's GSPMD recursion replicates about n² per
    device; `chol_sharded` and the panel factorization keep n²/p.
    `precision` has no effect (it picks TPU matmul passes)."""
    if isinstance(K, DTensor):
        K = K.full_tensor()
    L = chol_recursive(K, nb=nb)
    return distribute_tensor(L, mesh, _placements(mesh, axis, True),
                             src_data_rank=None)


class DistributedExactGP:
    """Exact GP whose Gram, Cholesky factor and predictive solves are
    row-sharded over a device mesh: the dense path for n beyond one
    device's memory.

    fit: each rank evaluates its rows of K = k(X, X) + s²I against all
         points (csrc/gram.cu on the card; padding rows and columns zero
         with a unit diagonal), factors them with the other ranks
         (`factorization`, see the module docstring), and solves for
         alpha panel by panel.
    predict: mean = K*ᵀ alpha (each rank its rows, summed), var = k** −
         ‖L⁻¹K*‖² column sums, K* row-sharded like K and gathered for the
         forward solve.

    `L` is the padded factor as a row-sharded `DTensor`; `alpha` is
    replicated. With `mesh=None` the mesh is every rank on one axis named
    `axis`, on the kernel's device."""

    def __init__(self, kernel_object, s: float = 0.1, mesh=None,
                 axis: str = "tp", nb: int = 1024,
                 factorization: str = "panels"):
        if factorization not in ("panels", "rec", "masked"):
            raise ValueError(factorization)
        self.kernel_object = kernel_object
        self.device = kernel_object.device
        self.dtype = kernel_object.dtype
        self.s = s
        if mesh is None:
            import torch.distributed as dist

            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_mesh((world,), (axis,), device=self.device)
        self.mesh = mesh
        self.axis = axis
        self.nb = nb
        self.factorization = factorization
        self.L = self.alpha = self.x = self.y = None

    def _padded_n(self, n: int) -> int:
        """Pad target: divisible by nb (blocked factorization) and by the
        mesh extent (row sharding)."""
        _, _, p = axis_info(self.mesh, self.axis)
        step = _step(self.nb, p)
        return -(-n // step) * step

    def _gram_rows(self, local, x_all, row0, n, nbe):
        """This rank's (nl, np_) rows of the padded K + s²I, built strip by
        strip into one buffer: padding rows and columns (global index ≥ n)
        zero, s² on the diagonal, 1 on the padding's diagonal."""
        ko = self.kernel_object
        nl, np_ = local.shape[0], x_all.shape[0]
        dev = local.device
        grows = row0 + torch.arange(nl, device=dev)
        dval = torch.full((nl,), self.s ** 2, dtype=self.dtype, device=dev)
        dval[grows >= n] = 1.0
        K_rows = torch.empty((nl, np_), dtype=self.dtype, device=dev)
        for c0 in range(0, np_, nbe):
            strip = K_rows[:, c0:c0 + nbe]
            strip.copy_(ko.eval_params(ko.params_dict, local,
                                       x_all[c0:c0 + nbe]))
            gcols = c0 + torch.arange(strip.shape[1], device=dev)
            if row0 + nl > n or c0 + strip.shape[1] > n:
                strip.masked_fill_((grows >= n)[:, None]
                                   | (gcols >= n)[None, :], 0.0)
            eq = grows[:, None] == gcols[None, :]
            strip.add_(eq.to(self.dtype) * dval[:, None])
        return K_rows

    def fit_gp(self, x, y):
        x = as_tensor(x, device=self.device, dtype=self.dtype)
        y = as_tensor(y, device=self.device, dtype=self.dtype).reshape(-1, 1)
        n = x.shape[0]
        np_ = self._padded_n(n)
        _, rank, p = axis_info(self.mesh, self.axis)
        nl = np_ // p
        x_pad = torch.cat([x, x.new_zeros((np_ - n, x.shape[1]))])
        local, x_all, row0 = rows_of(x_pad, self.mesh, self.axis)
        # the panel width: at most ~np_/16, so the (np_, nbe) gathered
        # panel stays a small part of the n²/p rows, and at least 128
        nbe = _panel_size(nl, min(self.nb, max(128, np_ // 16)))
        self.L = self.alpha = None
        K_rows = self._gram_rows(local, x_all, row0, n, nbe)
        mesh, axis = self.mesh, self.axis
        if self.factorization == "panels":
            step, k_panels = panel_step_strips(mesh, axis, np_, nbe)
            strips = _strips(K_rows, nbe)
            for j in range(k_panels):
                step(strips, j)
            L_rows = K_rows
        elif self.factorization == "masked":
            L_rows = _masked_rows(K_rows, row0, self.nb, mesh, axis)
            del K_rows
            nbe = _panel_size(nl, self.nb)
        else:
            K = gather_rows(K_rows, mesh, axis)
            del K_rows
            L_rows = chol_recursive(K, nb=self.nb)[row0:row0 + nl].clone()
            del K
            nbe = _panel_size(nl, self.nb)
        self._nbe = nbe
        self._fwd = solve_strips_sharded(mesh, axis, np_, nbe)
        bwd = solve_strips_sharded(mesh, axis, np_, nbe, transpose=True)
        strips = _strips(L_rows, nbe)
        ypad = torch.cat([y, y.new_zeros((np_ - n, 1))])
        self.alpha = bwd(strips, self._fwd(strips, ypad))[:n]
        self.L = row_dtensor(L_rows, mesh, axis, np_)
        self._x_local, self._row0 = local, row0
        self.x, self.y, self.n = x, y, n
        self._np = np_
        return self

    def mean_std(self, xtest):
        ko = self.kernel_object
        xt = as_tensor(xtest, device=self.device, dtype=self.dtype)
        n, np_, row0 = self.n, self._np, self._row0
        local = self._x_local
        nl = local.shape[0]
        Ks = ko.eval_params(ko.params_dict, local, xt)           # (nl, t)
        grows = row0 + torch.arange(nl, device=xt.device)
        Ks.masked_fill_((grows >= n)[:, None], 0.0)
        apad = torch.cat([self.alpha, self.alpha.new_zeros((np_ - n, 1))])
        mu = sum_over(Ks.T @ apad[row0:row0 + nl], self.mesh, self.axis)
        Ksp = gather_rows(Ks, self.mesh, self.axis)              # (np_, t)
        del Ks
        V = self._fwd(_strips(self.L.to_local(), self._nbe), Ksp)
        del Ksp
        kss = ko.diag(xt)
        var = torch.clamp(kss - torch.sum(V * V, dim=0), min=1e-30)
        return mu, torch.sqrt(var)[:, None]
