"""Double-float (hi, lo) Gram planning over `KernelFunction` atoms.

Port of stpy_tpu/kernels/df_plan.py (`df_atom_desc`, `df_gram_from_desc`,
`df_diag_from_desc`), read by the dense double tier (models/exact_gp.py) and
the matrix-free one (parallel/iterative.py). Per atom:

* SE / ARD / Matérn ½, 3/2, 5/2 → the df Gram of ops/gram_df.py
  (csrc/gram_df.cu on the card);
* laplace → its L1 family: κ·exp(−‖x − y‖₁/γ²), the single tier's kernel.
  The JAX package maps laplace to the L2 Matérn-½ here
  (stpy_tpu/kernels/df_plan.py:56-57), a different kernel; the port does
  not copy that (ROADMAP Queue 3);
* general-ν Matérn (`matern_gen`) and every other atom (`generic`: the
  additive families, polynomial, linear, gibbs, custom, ...) → the atom's
  own torch function (`_Atom.plain`) on float64 inputs and float64
  parameters, in row blocks, split into (hi, lo) by `split_f64`.

The JAX package needs a jaxpr double-float interpreter (ops/df_interp.py)
and a node-scanned df Bessel (ops/matern_df.py) for the last two because
the TPU has no f64; the card has, so neither is ported. Composites fold
their pairs in float64 and split again (`df_add`, `df_mul`); with
`strip_fold` the atoms after the first are built and folded in row strips,
in place. `gram64` is the float64 Gram of any kernel, on this plan where
the kernel is narrower than float64.
"""

from __future__ import annotations

import torch

from stpy_tpu_torch.ops.gram_df import df_add, df_mul, gram_df, split_f64

# elements of one float64 row block of a generic atom (256 MiB)
_GENERIC_BLOCK_ELEMS = 1 << 25


def df_atom_desc(kernel_object):
    """Static per-atom (index, family, nu, gamma_key, group, op) plan for
    the double-float Gram."""
    ko = kernel_object
    full = list(range(ko.d))
    desc = []
    for i, atom in enumerate(ko._atoms):
        group = atom.static.get("group")
        if group is not None and list(group) == full:
            group = None
        nu = float(atom.static.get("nu", 1.5))
        name = atom.name
        fam = gkey = None
        if atom.static.get("groups") is None:
            if name == "squared_exponential":
                fam, gkey, nu = "se", "gamma", 1.0
            elif name == "ard":
                fam, gkey, nu = "se", "ard_gamma", 1.0
            elif name in ("matern", "ard_matern"):
                fam = "matern" if nu in (0.5, 1.5, 2.5) else "matern_gen"
                gkey = "gamma" if name == "matern" else "ard_gamma"
            elif name == "laplace":
                fam, gkey, nu = "laplace", "gamma", 0.5
        if fam is None:
            # the atom's function receives full inputs and slices its own
            # group, as in eval_params
            fam, nu, group = "generic", 0.0, None
        desc.append((i, fam, nu, gkey,
                     None if group is None else tuple(group),
                     ko.operations[i]))
    return desc


def _generic_df_gram(kernel_object, i, p, a, b):
    """(hi, lo) Gram of atom i by its plain function in float64, in row
    blocks of at most `_GENERIC_BLOCK_ELEMS` float64 entries."""
    atom = kernel_object._atoms[i]
    f64 = torch.float64
    a64, b64 = a.to(f64), b.to(f64)
    rows = max(1, _GENERIC_BLOCK_ELEMS // max(1, b.shape[0]))
    hi = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                     device=a.device)
    lo = torch.empty_like(hi)
    with torch.no_grad():
        for r0 in range(0, a.shape[0], rows):
            h, l = split_f64(atom.plain(p, a64[r0:r0 + rows], b64).to(f64))
            hi[r0:r0 + rows], lo[r0:r0 + rows] = h, l
    return hi, lo


def _atom_df_gram(kernel_object, i, fam, nu, gkey, group, p, a, b):
    """(hi, lo) Gram of atom i on rows a against b."""
    if fam in ("generic", "matern_gen"):
        return _generic_df_gram(kernel_object, i, p, a, b)
    gamma = p[gkey]
    if group is not None:
        idx = torch.as_tensor(group, device=a.device)
        sel = a[:, idx]
        a, b = sel, (sel if b is a else b[:, idx])
        if gkey == "ard_gamma":
            gamma = gamma.reshape(-1)[idx.to(gamma.device)]
    return gram_df(a, b, gamma, p.get("kappa", 1.0), family=fam, nu=nu)


def df_gram_from_desc(kernel_object, params_dict, a, b, desc,
                      strip_fold=None):
    """(hi, lo) f32 Gram of the (possibly composite) kernel.

    strip_fold (int, default off): each atom after the first is built in
    `strip_fold`-row strips, each folded into the accumulated pair's rows
    in place, so the fold's peak is the pair (2n²) plus one strip and its
    float64 fold instead of two pairs and the float64 fold of all of them
    (stpy_tpu/kernels/df_plan.py:96-175; `GaussianProcess(fold_noise=True)`
    passes 4096). Every entry is computed as without it."""
    outh = outl = None
    for (i, fam, nu, gkey, group, op) in desc:
        p = {**kernel_object.params_dict[str(i)],
             **params_dict.get(str(i), {})}
        fold = {"+": df_add, "*": df_mul}.get(op)
        if (fold is None or not strip_fold
                or a.shape[0] <= strip_fold):
            Kh, Kl = _atom_df_gram(kernel_object, i, fam, nu, gkey, group, p,
                                   a, b)
            outh, outl = (Kh, Kl) if fold is None else fold(outh, outl, Kh,
                                                            Kl)
            continue
        for r0 in range(0, a.shape[0], strip_fold):
            kh, kl = _atom_df_gram(kernel_object, i, fam, nu, gkey, group, p,
                                   a[r0:r0 + strip_fold], b)
            rows = slice(r0, r0 + kh.shape[0])
            oh, ol = fold(outh[rows], outl[rows], kh, kl)
            outh[rows], outl[rows] = oh, ol
    return outh, outl


def df_diag_from_desc(kernel_object, params_dict, x, desc, chunk=512):
    """df (hi, lo) prior diagonal k**(x): the diagonals of chunked
    (chunk, chunk) df Grams of slices of x, so every atom family gets a
    double-float k**. The variance k** − q cancels; an f32 k** would floor
    it at eps·k**/var for kernels whose k** is not an f32 number."""
    hs, ls = [], []
    for r0 in range(0, x.shape[0], chunk):
        xt = x[r0:r0 + chunk]
        Dh, Dl = df_gram_from_desc(kernel_object, params_dict, xt, xt, desc)
        hs.append(torch.diagonal(Dh))
        ls.append(torch.diagonal(Dl))
    return torch.cat(hs), torch.cat(ls)


def gram64(kernel_object, a, b=None):
    """K(a, b) in float64 (the symmetrised K(a, a) where b is None): on a
    kernel narrower than float64 its double-float Gram of the float64
    points (csrc/gram_df.cu on the card for the fused families), else the
    kernel's own Gram."""
    ko = kernel_object
    f64 = torch.float64
    if ko.dtype != f64:
        a64 = a.to(f64)
        b64 = a64 if b is None else b.to(f64)
        Kh, Kl = df_gram_from_desc(ko, ko.params_dict, a64, b64,
                                   df_atom_desc(ko))
        K = Kh.to(f64) + Kl.to(f64)
        return 0.5 * (K + K.T) if b is None else K
    return ko.gram(a) if b is None else ko.cross(a, b)
