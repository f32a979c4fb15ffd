"""Finite feature maps Φ with k(x, y) ≈ Φ(x)ᵀΦ(y) (port of
stpy_tpu/embeddings). The positive and Bernstein bases and Nyström's
positive subclasses (`PositiveNystromEmbeddingBump`,
`OptimalPositiveBasis`) come with the point-process stack, ROADMAP Queue 1
item 9."""

from stpy_tpu_torch.embeddings.base import Embedding, box_trig_integrals
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
    nmf_multiplicative,
)
from stpy_tpu_torch.embeddings.polynomial import (
    ChebyschevEmbedding,
    CustomEmbedding,
    OnehotEmbedding,
    PackingEmbedding,
    PolynomialEmbedding,
)
from stpy_tpu_torch.embeddings.random_nn import (
    RandomMap,
    RandomNestedMap,
    RandomOrthogonalMap,
)

__all__ = [
    "AdditiveEmbeddings", "ChebyschevEmbedding", "ClenshawCurtisEmbedding",
    "ConcatEmbedding", "CustomEmbedding", "Embedding", "HermiteEmbedding",
    "KLEmbedding", "LatticeEmbedding", "MaskedEmbedding", "MaternEmbedding",
    "NystromFeatures", "OnehotEmbedding", "OverCompleteHermiteEmbedding",
    "PackingEmbedding", "PolynomialEmbedding", "ProjectiveEmbeddings",
    "QuadPeriodicEmbedding", "QuadratureEmbedding", "RFFEmbedding",
    "RandomMap", "RandomNestedMap", "RandomOrthogonalMap",
    "TrapezoidalEmbedding", "WeightedEmbedding", "box_trig_integrals",
    "nmf_multiplicative",
]
