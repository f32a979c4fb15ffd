"""Bayesian-optimisation test functions and data-backed benchmarks (port of
stpy_tpu/test_functions)."""

from stpy_tpu_torch.test_functions.benchmarks import (
    BenchmarkFunction,
    CamelbackBenchmark,
    QuadraticBenchmark,
    PolynomialBenchmark,
    MichalBenchmark,
    StybTangBenchmark,
    GeneralizedAdditiveOverlap,
    CustomBenchmark,
    GaussianProcessSample,
    KernelizedSample,
    Simple1DFunction,
    MultiRKHS,
    LinearBenchmark,
)
from stpy_tpu_torch.test_functions.protein_benchmark import (
    ProteinBenchmark,
    ProteinOperator,
)
from stpy_tpu_torch.test_functions.swissfel_simulator import FelSimulator

__all__ = ["BenchmarkFunction", "CamelbackBenchmark", "CustomBenchmark",
           "FelSimulator", "GaussianProcessSample",
           "GeneralizedAdditiveOverlap", "KernelizedSample",
           "LinearBenchmark", "MichalBenchmark", "MultiRKHS",
           "PolynomialBenchmark", "ProteinBenchmark", "ProteinOperator",
           "QuadraticBenchmark", "Simple1DFunction", "StybTangBenchmark"]
