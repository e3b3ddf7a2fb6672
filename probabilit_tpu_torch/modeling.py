"""Parity module: ``probabilit_tpu_torch.modeling``.

The surface of the JAX package's ``probabilit_tpu.modeling`` (nodes,
transforms, distributions, and the names its reference imports into the
same namespace), from the port's implementations, so a model ports with
an import rename only.
"""

from probabilit_tpu_torch.models.graph import *  # noqa: F401,F403
from probabilit_tpu_torch.models.graph import __all__ as _graph_all
from probabilit_tpu_torch.models.distributions import (  # noqa: F401
    AbstractDistribution,
    CopulaDistribution,
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EllipticalCopulaDistribution,
    EmpiricalCopulaDistribution,
    EmpiricalDistribution,
    MarginalDistribution,
    MultivariateDistribution,
    QuantileTransform,
)
from probabilit_tpu_torch.garbage_collector import GarbageCollector  # noqa: F401
from probabilit_tpu_torch.models.processes import (  # noqa: F401
    BrownianMotion,
    CorrelatedGBM,
    GeometricBrownianMotion,
    MertonJumpDiffusion,
    OrnsteinUhlenbeck,
    PathDistribution,
    PathFunctional,
    PoissonProcess,
)
from probabilit_tpu_torch.ops.correlation import Cholesky, ImanConover  # noqa: F401
from probabilit_tpu_torch.ops.ncm import nearest_correlation_matrix  # noqa: F401
from probabilit_tpu_torch.utils.helpers import build_corrmat, zip_args  # noqa: F401

__all__ = list(_graph_all) + [
    "AbstractDistribution",
    "Distribution",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "MarginalDistribution",
    "MultivariateDistribution",
    "CopulaDistribution",
    "EllipticalCopulaDistribution",
    "EmpiricalCopulaDistribution",
    "QuantileTransform",
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "PathDistribution",
    "PathFunctional",
    "GarbageCollector",
    "Cholesky",
    "ImanConover",
    "nearest_correlation_matrix",
    "build_corrmat",
    "zip_args",
]
