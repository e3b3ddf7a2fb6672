"""Parity module: ``probabilit_tpu_torch.correlation``.

The surface of the JAX package's ``probabilit_tpu.correlation``:
correlators, the nearest correlation matrix, decorrelation, and the
permutation machinery, from the port's implementations.
"""

from probabilit_tpu_torch.ops.correlation import (  # noqa: F401
    Cholesky,
    Correlator,
    CorrelatorError,
    ImanConover,
    StudentTCopula,
    decorrelate,
)
from probabilit_tpu_torch.ops.ncm import nearest_correlation_matrix  # noqa: F401
from probabilit_tpu_torch.ops.permutation import (  # noqa: F401
    CorrelationMatrix,
    PermutationCorrelator,
    SwapIndexGenerator,
)

__all__ = [
    "Correlator",
    "CorrelatorError",
    "Cholesky",
    "ImanConover",
    "StudentTCopula",
    "PermutationCorrelator",
    "CorrelationMatrix",
    "SwapIndexGenerator",
    "decorrelate",
    "nearest_correlation_matrix",
]
