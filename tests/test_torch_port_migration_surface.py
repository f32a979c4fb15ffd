"""The port's twin of tests/test_migration_surface.py: every name of the
migration table (docs/MIGRATION.md) imports from `stpy_tpu_torch` under the
same module path, the multi-device tier of `parallel` (`DistributedExactGP`,
`make_lazy_matvec_sharded`, the `mesh` and `data` names) included."""


def test_port_migration_table_imports():
    from stpy_tpu_torch.domains import (          # noqa: F401
        BallSet, BorelSet, CandidateDiscreteSet, CandidateSet,
        HierarchicalBorelSets, Node,
    )
    from stpy_tpu_torch.kernels import KernelFunction            # noqa: F401
    from stpy_tpu_torch.models.estimator import Estimator        # noqa: F401
    from stpy_tpu_torch.viz import RandomProcess                 # noqa: F401
    from stpy_tpu_torch.models import (           # noqa: F401
        ConvexRKHS, DirichletMixture, CategoricalMixture, GammaContProcess,
        GaussianProcess, GaussianProcessFF, KernelizedFeatures, MKL,
        MultipleKernelLearner, PrimalMKL, TraceFeatures,
        TruncatedKernelizedFeatures,
    )
    from stpy_tpu_torch.embeddings import (       # noqa: F401
        AdditiveEmbeddings, BernsteinEmbedding, BernsteinSplinesEmbedding,
        BernsteinSplinesOverlapping, BumpsEmbedding, ChebyschevEmbedding,
        ClenshawCurtisEmbedding, ConcatEmbedding, CustomEmbedding,
        CustomHaarBumps, FaberSchauderEmbedding, HermiteEmbedding,
        KLEmbedding, KuhnExponentialEmbedding, LatticeEmbedding,
        MaskedEmbedding, MaternEmbedding, NystromFeatures,
        OptimalPositiveBasis, OverCompleteHermiteEmbedding,
        PackingEmbedding, PolynomialEmbedding,
        PositiveNystromEmbeddingBump, ProjectiveEmbeddings,
        QuadPeriodicEmbedding, QuadratureEmbedding, RFFEmbedding, RandomMap,
        RandomNestedMap, RandomOrthogonalMap, TrapezoidalEmbedding,
        TriangleEmbedding, WeightedEmbedding,
    )
    from stpy_tpu_torch.point_processes import (  # noqa: F401
        BernoulliPointProcess, BernoulliRateEstimator,
        ExpGaussProcessRateEstimator, LogGaussProcessRateEstimator,
        LogLinearRateEstimator, LogisticGaussProcessRateEstimator,
        MBRPositiveEstimator, PermanentalProcessRateEstimator,
        PoissonPointProcess, PoissonRateEstimator, RateEstimator,
    )
    from stpy_tpu_torch.probability import (      # noqa: F401
        BernoulliLikelihoodCanonical, GaussianLikelihood, GaussianNoise,
        HuberLikelihood, LaplaceLikelihood, Likelihood, NoiseModel,
        PoissonLikelihoodCanonical, RobustGraphicalLikelihood,
        WeibullLikelihoodCanonical, WeilbullLikelihoodCanonical,
    )
    from stpy_tpu_torch.regularization import Regularizer        # noqa: F401
    from stpy_tpu_torch.regularization.constraints import Constraints  # noqa: F401
    from stpy_tpu_torch.opt import bisection, newton_solve       # noqa: F401
    from stpy_tpu_torch.inference import (        # noqa: F401
        HmcSampler, LangevinSampler, MirrorLangevin, ProximalLangevin,
        mirror_langevin_box, proximal_langevin, tmg, ula,
    )
    from stpy_tpu_torch.approx_inference import VMF_SGCP         # noqa: F401
    from stpy_tpu_torch.helpers import (          # noqa: F401
        cartesian, interval, maximize_on_elliptical_slice,
    )
    from stpy_tpu_torch.embeddings.base import box_trig_integrals  # noqa: F401
    from stpy_tpu_torch.test_functions import (   # noqa: F401
        BenchmarkFunction, FelSimulator, ProteinBenchmark, ProteinOperator,
    )
    from stpy_tpu_torch.generative_models import CVAE            # noqa: F401
    from stpy_tpu_torch.dimred import SRI                        # noqa: F401
    from stpy_tpu_torch.feature_importance import FeatureRanker  # noqa: F401
    from stpy_tpu_torch.parallel import (         # noqa: F401
        DistributedExactGP, IterativeGP, cg_solve_block,
        evidence_value_and_grad_lazy, make_lazy_matvec,
        make_lazy_matvec_sharded,
    )
    from stpy_tpu_torch.parallel import (         # noqa: F401
        HostShardedLoader, distributed_evidence, fit_feature_gp_sharded,
        host_sharded, make_mesh, replicate, restart_farm, shard_rows,
        sharded_gram, streamed_feature_stats,
    )
    from stpy_tpu_torch.configs import (          # noqa: F401
        GPConfig, KernelConfig, PoissonRateConfig,
    )
