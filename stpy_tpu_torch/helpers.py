"""Alias module of the reference's `helpers` package layout (the port of
stpy_tpu/helpers.py): one import point for grids, groups, sampling,
transforms, scores, coresets, the ellipsoid tools, HMC and the truncated
Gaussian sampler. It re-exports and defines nothing."""

from stpy_tpu_torch.utils.helper import (  # noqa: F401
    cartesian,
    interval,
    interval_grid,
    logdet,
    symsqrt,
)
from stpy_tpu_torch.utils.groups import generate_groups  # noqa: F401
from stpy_tpu_torch.utils.sampling import (  # noqa: F401
    halton_sequence,
    randomly_split_set_without_duplicates,
    randomly_split_set_without_duplicates_balanced,
    rejection_sampling,
    sample_bounded,
    sample_qmc_halton,
    sample_uniform_sphere,
    vdc,
)
from stpy_tpu_torch.utils.transforms import (  # noqa: F401
    haar_coefficients,
    haar_fisz_transform,
    haarval,
    inverse_haar_fisz_transform,
    r_score_std,
    transform,
)
from stpy_tpu_torch.utils.coresets import (  # noqa: F401
    coreset,
    coreset_leverage_score_greedy,
    epsilon_net,
)
from stpy_tpu_torch.opt.ellipsoid import (  # noqa: F401
    KY_initialization,
    ellipsoid_cut,
    maximize_on_elliptical_slice,
    maximize_quadratic_on_ellipse,
    maximum_volume_ellipsoid,
    minimize_quadratic_on_ellipse,
)
from stpy_tpu_torch.inference.hmc import HmcSampler  # noqa: F401
from stpy_tpu_torch.inference.tmg import tmg_sample as tmg  # noqa: F401
from stpy_tpu_torch.embeddings.base import box_trig_integrals  # noqa: F401
