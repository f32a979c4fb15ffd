"""Large-n inference on one device: the matrix-free Gram products, CG
solvers, low-rank preconditioners and `IterativeGP` (port of the
single-device part of stpy_tpu/parallel; the mesh tiers, `bbmm`, `slq` and
`data` wait for their own slice, ROADMAP Queue 1 item 11)."""

from stpy_tpu_torch.ops.gram_matvec import (
    gram_matmat,
    gram_matvec,
    make_lazy_matmat,
    make_lazy_matvec,
)
from stpy_tpu_torch.parallel.iterative import (
    IterativeGP,
    cg_solve,
    cg_solve_block,
    lowrank_eigen_precond,
    make_pivchol_precond,
    nystrom_precond_from_cross,
    pivoted_cholesky_kernel,
    rayleigh_nystrom_precond,
)
from stpy_tpu_torch.parallel.lazy_kernel import (
    fast_atoms,
    make_chunked_matmat,
    make_chunked_matvec,
    make_sum_matmat,
    make_sum_matvec,
)

__all__ = [
    "IterativeGP", "cg_solve", "cg_solve_block", "fast_atoms", "gram_matmat",
    "gram_matvec", "lowrank_eigen_precond", "make_chunked_matmat",
    "make_chunked_matvec", "make_lazy_matmat", "make_lazy_matvec",
    "make_pivchol_precond", "make_sum_matmat", "make_sum_matvec",
    "nystrom_precond_from_cross", "pivoted_cholesky_kernel",
    "rayleigh_nystrom_precond",
]
