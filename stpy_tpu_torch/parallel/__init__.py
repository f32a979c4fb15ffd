"""Large-n inference: the matrix-free Gram products, CG solvers, low-rank
preconditioners, `IterativeGP`, stochastic Lanczos quadrature and the
matrix-free evidence fit, fused and general tiers, and the multi-device
tier on torch.distributed (a `DeviceMesh`, one rank per device: `mesh`,
`blocked`, `data`, the mesh tiers of `IterativeGP` and the `make_*_sharded`
products). Port of stpy_tpu/parallel."""

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
    make_lazy_matvec_sharded,
    make_sum_matmat,
    make_sum_matvec,
)
from stpy_tpu_torch.parallel.mesh import (
    distributed_evidence,
    make_mesh,
    replicate,
    restart_farm,
    shard_rows,
    sharded_gram,
)
from stpy_tpu_torch.parallel.blocked import (
    DistributedExactGP,
    blocked_cholesky,
    chol_sharded,
    chol_sharded_rec,
)
from stpy_tpu_torch.parallel.data import (
    HostShardedLoader,
    fit_feature_gp_sharded,
    host_sharded,
    streamed_feature_stats,
)
from stpy_tpu_torch.parallel.slq import (
    evidence_matvec_only,
    slq_logdet,
    slq_trace_fn,
)

__all__ = [
    "DistributedExactGP", "HostShardedLoader", "IterativeGP",
    "blocked_cholesky", "cg_solve", "cg_solve_block", "chol_sharded",
    "chol_sharded_rec", "distributed_evidence", "fit_feature_gp_sharded",
    "host_sharded", "make_lazy_matvec_sharded", "make_mesh", "replicate",
    "restart_farm", "shard_rows", "sharded_gram", "streamed_feature_stats",
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
