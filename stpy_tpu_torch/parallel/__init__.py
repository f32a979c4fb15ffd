"""Large-n inference on one device: the matrix-free Gram products, CG
solvers, low-rank preconditioners, `IterativeGP`, stochastic Lanczos
quadrature and the matrix-free evidence fit, fused and general tiers (port
of the single-device part of stpy_tpu/parallel; the mesh tiers and `data`
wait for their own slice, ROADMAP Queue 1 item 11)."""

from stpy_tpu_torch.ops.gram_matvec import (
    gram_matmat,
    gram_matvec,
    make_lazy_matmat,
    make_lazy_matvec,
)
from stpy_tpu_torch.parallel.bbmm import (
    evidence_value_and_grad_general,
    evidence_value_and_grad_lazy,
    evidence_value_and_grad_sum,
    fit_evidence_general,
    fit_evidence_lazy,
    fit_evidence_sum,
)
from stpy_tpu_torch.parallel.iterative import (
    IterativeGP,
    cg_solve,
    cg_solve_block,
    lowrank_eigen_precond,
    make_pivchol_precond,
    nystrom_precond_from_cross,
    pivoted_cholesky_kernel,
    randomized_eig_precond,
    rayleigh_nystrom_precond,
)
from stpy_tpu_torch.parallel.lazy_kernel import (
    fast_atoms,
    make_chunked_matmat,
    make_chunked_matvec,
    make_sum_matmat,
    make_sum_matvec,
)
from stpy_tpu_torch.parallel.slq import (
    evidence_matvec_only,
    slq_logdet,
    slq_trace_fn,
)

__all__ = [
    "IterativeGP", "cg_solve", "cg_solve_block",
    "evidence_matvec_only", "evidence_value_and_grad_general",
    "evidence_value_and_grad_lazy", "evidence_value_and_grad_sum",
    "fast_atoms", "fit_evidence_general", "fit_evidence_lazy",
    "fit_evidence_sum", "gram_matmat", "gram_matvec",
    "lowrank_eigen_precond", "make_chunked_matmat", "make_chunked_matvec",
    "make_lazy_matmat", "make_lazy_matvec", "make_pivchol_precond",
    "make_sum_matmat", "make_sum_matvec", "nystrom_precond_from_cross",
    "pivoted_cholesky_kernel", "randomized_eig_precond",
    "rayleigh_nystrom_precond", "slq_logdet", "slq_trace_fn",
]
