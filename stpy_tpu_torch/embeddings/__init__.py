"""Finite feature maps Φ with k(x, y) ≈ Φ(x)ᵀΦ(y) (port of
stpy_tpu/embeddings), with the positive and Bernstein bases of the
point-process stack."""

from stpy_tpu_torch.embeddings.base import Embedding, box_trig_integrals
from stpy_tpu_torch.embeddings.bernstein import (
    BernsteinEmbedding,
    BernsteinSplinesEmbedding,
    BernsteinSplinesOverlapping,
)
from stpy_tpu_torch.embeddings.combinators import (
    AdditiveEmbeddings,
    ConcatEmbedding,
    MaskedEmbedding,
    ProjectiveEmbeddings,
    WeightedEmbedding,
)
from stpy_tpu_torch.embeddings.fourier import (
    ClenshawCurtisEmbedding,
    HermiteEmbedding,
    KLEmbedding,
    LatticeEmbedding,
    MaternEmbedding,
    OverCompleteHermiteEmbedding,
    QuadPeriodicEmbedding,
    QuadratureEmbedding,
    RFFEmbedding,
    TrapezoidalEmbedding,
)
from stpy_tpu_torch.embeddings.nystrom import (
    NystromFeatures,
    OptimalPositiveBasis,
    PositiveNystromEmbeddingBump,
    nmf_multiplicative,
)
from stpy_tpu_torch.embeddings.polynomial import (
    ChebyschevEmbedding,
    CustomEmbedding,
    OnehotEmbedding,
    PackingEmbedding,
    PolynomialEmbedding,
)
from stpy_tpu_torch.embeddings.positive import (
    BumpsEmbedding,
    CustomHaarBumps,
    FaberSchauderEmbedding,
    KuhnExponentialEmbedding,
    PositiveEmbedding,
    TriangleEmbedding,
)
from stpy_tpu_torch.embeddings.random_nn import (
    RandomMap,
    RandomNestedMap,
    RandomOrthogonalMap,
)

__all__ = [
    "AdditiveEmbeddings", "BernsteinEmbedding", "BernsteinSplinesEmbedding",
    "BernsteinSplinesOverlapping", "BumpsEmbedding", "ChebyschevEmbedding",
    "ClenshawCurtisEmbedding", "ConcatEmbedding", "CustomEmbedding",
    "CustomHaarBumps", "Embedding", "FaberSchauderEmbedding",
    "HermiteEmbedding", "KLEmbedding", "KuhnExponentialEmbedding",
    "LatticeEmbedding", "MaskedEmbedding", "MaternEmbedding",
    "NystromFeatures", "OnehotEmbedding", "OptimalPositiveBasis",
    "OverCompleteHermiteEmbedding", "PackingEmbedding", "PolynomialEmbedding",
    "PositiveEmbedding", "PositiveNystromEmbeddingBump",
    "ProjectiveEmbeddings", "QuadPeriodicEmbedding", "QuadratureEmbedding",
    "RFFEmbedding", "RandomMap", "RandomNestedMap", "RandomOrthogonalMap",
    "TrapezoidalEmbedding", "TriangleEmbedding", "WeightedEmbedding",
    "box_trig_integrals", "nmf_multiplicative",
]
