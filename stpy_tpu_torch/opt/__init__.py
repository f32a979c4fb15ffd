from stpy_tpu_torch.opt.ellipsoid import (
    maximize_on_ellipsoid,
    maximize_on_elliptical_slice,
    project_ellipsoid,
)
from stpy_tpu_torch.opt.lbfgs import (
    LBFGSResult,
    make_box_bijector,
    make_positive_bijector,
    minimize_lbfgs,
    minimize_newton_small,
)
from stpy_tpu_torch.opt.manifold import (
    optimize_psd,
    optimize_stiefel,
    stiefel_project_tangent,
)
from stpy_tpu_torch.opt.prox import (
    SolveResult,
    fista_backtracking,
    fista_prox_backtracking,
    project_l2_ball,
    project_simplex,
    projected_fista,
    projected_gradient,
    prox_box,
    prox_group_l2,
    prox_l1,
)
from stpy_tpu_torch.opt.scalar import bisection, golden_section, newton_1d
