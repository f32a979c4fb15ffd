from stpy_tpu_torch.opt.lbfgs import (
    LBFGSResult,
    make_box_bijector,
    make_positive_bijector,
    minimize_lbfgs,
    minimize_newton_small,
)
from stpy_tpu_torch.opt.scalar import golden_section
