"""Double-float (hi, lo) Gram planning over `KernelFunction` atoms.

Port of the fused-family part of stpy_tpu/kernels/df_plan.py
(`df_atom_desc`, `df_gram_from_desc`, `df_diag_from_desc`). Every atom goes
through the df Gram of ops/gram_df.py; composites fold their pairs in
float64 and split again (ops/gram_df.df_add / df_mul). The general-ν Matérn
and generic-interpreter tiers (`matern_gen`, `generic`) and `strip_fold` are
not ported: the general double tier is ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.ops.gram_df import df_add, df_mul, gram_df


def df_atom_desc(kernel_object):
    """Static per-atom (index, family, nu, gamma_key, group, op) plan for
    the double-float Gram. Raises for atoms outside the fused families."""
    ko = kernel_object
    full = list(range(ko.d))
    desc = []
    for i, atom in enumerate(ko._atoms):
        group = atom.static.get("group")
        if group is not None and list(group) == full:
            group = None
        nu = float(atom.static.get("nu", 1.5))
        name = atom.name
        if name == "squared_exponential":
            fam, gkey, nu = "se", "gamma", 1.0
        elif name == "ard":
            fam, gkey, nu = "se", "ard_gamma", 1.0
        elif name in ("matern", "ard_matern") and nu in (0.5, 1.5, 2.5):
            fam = "matern"
            gkey = "gamma" if name == "matern" else "ard_gamma"
        elif name == "laplace":
            # the JAX package's double tier maps laplace to the L2 Matérn-½
            # (stpy_tpu/kernels/df_plan.py:56-57), a different kernel from
            # the L1 one of its single tier; the port does not copy that
            raise NotImplementedError(
                "precision='double' for the laplace atom: the reference's "
                "double tier computes an L2 Matérn-1/2 instead of the L1 "
                "Laplace kernel, ROADMAP Queue 3"
            )
        else:
            raise NotImplementedError(
                f"precision='double' for kernel atom {name!r}: the "
                "matern_gen and generic df tiers are ROADMAP Queue 1 item 7"
            )
        desc.append((i, fam, nu, gkey,
                     None if group is None else tuple(group),
                     ko.operations[i]))
    return desc


def df_gram_from_desc(kernel_object, params_dict, a, b, desc):
    """(hi, lo) f32 Gram of the (possibly composite) kernel."""
    outh = outl = None
    for (i, fam, nu, gkey, group, op) in desc:
        p = {**kernel_object.params_dict[str(i)],
             **params_dict.get(str(i), {})}
        gamma = p[gkey]
        if group is not None:
            idx = torch.as_tensor(group, device=a.device)
            a_, b_ = a[:, idx], b[:, idx]
            if gkey == "ard_gamma":
                gamma = gamma.reshape(-1)[idx.to(gamma.device)]
        else:
            a_, b_ = a, b
        Kh, Kl = gram_df(a_, b_, gamma, p.get("kappa", 1.0), family=fam,
                         nu=nu)
        if op == "+":
            outh, outl = df_add(outh, outl, Kh, Kl)
        elif op == "*":
            outh, outl = df_mul(outh, outl, Kh, Kl)
        else:
            outh, outl = Kh, Kl
    return outh, outl


def df_diag_from_desc(kernel_object, params_dict, x, desc, chunk=512):
    """df (hi, lo) prior diagonal k**(x): the diagonals of chunked
    (chunk, chunk) df Grams of slices of x, so every df atom family gets a
    double-float k**. The variance k** − q cancels; an f32 k** would floor
    it at eps·k**/var for kernels whose k** is not an f32 number."""
    hs, ls = [], []
    for r0 in range(0, x.shape[0], chunk):
        xt = x[r0:r0 + chunk]
        Dh, Dl = df_gram_from_desc(kernel_object, params_dict, xt, xt, desc)
        hs.append(torch.diagonal(Dh))
        ls.append(torch.diagonal(Dl))
    return torch.cat(hs), torch.cat(ls)
