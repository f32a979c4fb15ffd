"""Regularizers and constraints (port of stpy_tpu/regularization): values,
proxes, penalties and projections as plain tensor functions that follow
their argument's device and dtype."""

from stpy_tpu_torch.regularization.regularizer import (
    Regularizer,
    L2Regularizer,
    L1Regularizer,
    GroupL1L2Regularizer,
    NonConvexLqRegularizer,
    GroupNonConvexLqRegularizer,
    NestedGroupL1L2Regularizer,
)
from stpy_tpu_torch.regularization.simplex_regularizer import (
    ProbabilityRegularizer,
    SupRegularizer,
    DirichletRegularizer,
    WeightedAitchisonRegularizer,
    L1MeasureRegularizer,
)
from stpy_tpu_torch.regularization.constraints import (
    Constraints,
    CustomConstraint,
    LinearConstraint,
    AbsoluteValueConstraint,
    QuadraticInequalityConstraint,
    NonConvexNormConstraint,
    NonConvexGroupNormConstraint,
    SDPConstraint,
)
