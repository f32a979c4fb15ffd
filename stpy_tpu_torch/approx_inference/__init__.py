"""Approximate inference (port of stpy_tpu/approx_inference): the
sigmoidal Gaussian Cox process by variational inference, and expectation
propagation with Gaussian sites."""

from stpy_tpu_torch.approx_inference.sgcp import SGCPVariational, VMF_SGCP
from stpy_tpu_torch.approx_inference.expected_propagation import (
    ExpectedPropagationQuadratic,
)
