"""Matrix-free views of KernelFunction objects, on one device.

Port of the single-device part of stpy_tpu/parallel/lazy_kernel.py. Two
tiers, neither stores an (n, n) Gram:

  * fast tier (`fast_atoms`): kernels that are sums of fused atoms (SE / ARD
    / Matérn ν ∈ {½, 3/2, 5/2}, each optionally on a coordinate `group`).
    The matvec is one matrix-free Gram product per atom
    (ops/gram_matvec.py: csrc/gram_matvec.cu, csrc/gram_matmat.cu on the
    card).
  * general tier (`make_chunked_matvec` / `make_chunked_matmat`): any kernel
    the port can build (products, Laplace, …), one (chunk, n) block of
    `kernel_object.eval_params` at a time — on the card through the ported
    Gram kernels. Differentiable in the `pd` passed per call, through the
    hand Grams' autograd Functions (`ops.gram._Gram`, `ops.gram_l1._GramL1`);
    each chunk is checkpointed (`torch.utils.checkpoint`, the JAX tier's
    `jax.checkpoint`), so a graph over all chunks holds no (chunk, n) tile
    and the backward rebuilds one at a time: O(n·chunk) memory in both
    directions, also for a product kernel, whose `*` would otherwise keep
    both factors' tiles.

The mesh variants (`make_*_sharded`) wait for torch.distributed (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from stpy_tpu_torch.ops.gram import _as_factor
from stpy_tpu_torch.ops.gram_matvec import gram_matmat_scaled, gram_matvec_scaled


@dataclass
class FastAtom:
    """One fused kernel atom inside a sum."""
    index: int                 # position in kernel_object._atoms
    family: str                # "se" | "matern"
    nu: float
    gamma_key: str             # "gamma" | "ard_gamma"
    group: tuple | None = None # coordinate subset, None = all dims

    def slice_x(self, x):
        if self.group is None:
            return x
        return x[:, torch.as_tensor(self.group, device=x.device)]


def fast_atoms(kernel_object):
    """[FastAtom, ...] if `kernel_object` is a SUM of fused atoms (ops all
    '+'), else None. A single atom counts as a one-term sum."""
    atoms = getattr(kernel_object, "_atoms", None)
    if not atoms:
        return None
    if any(op not in ("-", "+") for op in kernel_object.operations):
        return None
    out = []
    d = kernel_object.d
    for i, atom in enumerate(atoms):
        if atom.static.get("groups") is not None:
            return None  # additive-over-groups atoms: the general tier
        nu = atom.static.get("nu", 1.5)
        group = atom.static.get("group")
        if group is not None and list(group) == list(range(d)):
            group = None
        gt = None if group is None else tuple(group)
        if atom.name == "squared_exponential":
            out.append(FastAtom(i, "se", 1.0, "gamma", gt))
        elif atom.name == "ard":
            out.append(FastAtom(i, "se", 1.0, "ard_gamma", gt))
        elif atom.name == "matern" and nu in (0.5, 1.5, 2.5):
            out.append(FastAtom(i, "matern", float(nu), "gamma", gt))
        elif atom.name == "ard_matern" and nu in (0.5, 1.5, 2.5):
            out.append(FastAtom(i, "matern", float(nu), "ard_gamma", gt))
        else:
            return None
    return out


def atom_params(kernel_object, atom: FastAtom):
    """(gamma, kappa) of one fast atom from the kernel's params_dict. For
    grouped ARD atoms the stored per-dim vector is sliced to the group's
    coordinates (as KernelFunction._make_fn does)."""
    p = kernel_object.params_dict[str(atom.index)]
    gamma = p[atom.gamma_key]
    if atom.gamma_key == "ard_gamma" and atom.group is not None:
        gamma = gamma.reshape(-1)[torch.as_tensor(atom.group,
                                                  device=gamma.device)]
    return gamma, p.get("kappa", 1.0)


def _scaled_atoms(x, atoms, gammas, kappas):
    """Per atom (x̃ = x[:, group]/γ, κ as a float, family, ν): the scaling
    and the κ read happen once, not at every product."""
    out = []
    for a, g, k in zip(atoms, gammas, kappas):
        xa = a.slice_x(x)
        out.append((xa / _as_factor(g, xa), float(k), a.family, a.nu))
    return out


def make_sum_matvec(x, atoms, gammas, kappas, *, noise=0.0):
    """matvec(v) = (Σ_a κ_a K_a + σ²I)·v over matrix-free Gram passes."""
    scaled = _scaled_atoms(x, atoms, gammas, kappas)

    def matvec(v):
        v = v.reshape(-1)
        out = (noise * noise) * v
        for xs, k, fam, nu in scaled:
            out = out + gram_matvec_scaled(xs, xs, v, k, fam, nu)
        return out

    return matvec


def make_sum_matmat(x, atoms, gammas, kappas, *, noise=0.0):
    """Block-RHS companion of `make_sum_matvec`: (Σ κ_a K_a + σ²I)·V."""
    scaled = _scaled_atoms(x, atoms, gammas, kappas)

    def matmat(V):
        out = (noise * noise) * V
        for xs, k, fam, nu in scaled:
            out = out + gram_matmat_scaled(xs, xs, V, k, fam, nu)
        return out

    return matmat


def _requires_grad(pd) -> bool:
    return any(isinstance(v, torch.Tensor) and v.requires_grad
               for p in pd.values() for v in p.values())


def make_chunked_matvec(kernel_object, x, params_dict=None, *, noise=0.0,
                        chunk=2048):
    """(K(θ) + σ²I)·v for ANY kernel, one (chunk, n) Gram block at a time:
    `matvec(v, pd=None)`, θ the `pd` of the call (else `params_dict`, else
    the kernel's). Differentiable in `pd` (see `make_chunked_matmat`); σ²
    enters outside, so a caller differentiates the noise itself."""
    matmat = make_chunked_matmat(kernel_object, x, params_dict, noise=noise,
                                 chunk=chunk)

    def matvec(v, pd=None):
        return matmat(v.reshape(-1, 1), pd)[:, 0]

    return matvec


def make_chunked_matmat(kernel_object, x, params_dict=None, *, noise=0.0,
                        chunk=2048):
    """Block-RHS version: (K(θ) + σ²I)·V, V of shape (n, r). Where a leaf
    of `pd` needs a gradient (and grad mode is on), each chunk's product
    runs under a non-reentrant checkpoint: the graph keeps the chunk's
    rows, not its (chunk, n) tile, and the backward recomputes the tile,
    one chunk at a time."""

    def matmat(V, pd=None):
        pd_eff = pd if pd is not None else (
            params_dict or kernel_object.params_dict)

        def rows(xc, V):
            return kernel_object.eval_params(pd_eff, xc, x) @ V

        ckpt = torch.is_grad_enabled() and _requires_grad(pd_eff)
        out = torch.cat([
            checkpoint(rows, x[r0:r0 + chunk], V, use_reentrant=False)
            if ckpt else rows(x[r0:r0 + chunk], V)
            for r0 in range(0, x.shape[0], chunk)])
        return out + (noise * noise) * V

    return matmat
