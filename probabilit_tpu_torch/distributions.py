"""Parity module: ``probabilit_tpu_torch.distributions``.

The surface of the JAX package's ``probabilit_tpu.distributions``: the
named factories with friendly parametrisations, from the port's
implementations.
"""

from probabilit_tpu_torch.models.factories import (  # noqa: F401
    PERT,
    ClaytonCopula,
    EmpiricalCopula,
    FrankCopula,
    GaussianCopula,
    GumbelCopula,
    Lognormal,
    Normal,
    TCopula,
    Triangular,
    TruncatedNormal,
    Uniform,
    _fit_triangular_distribution,
    _pert_to_beta,
)

# Importable from this path too, as in the JAX package.
from probabilit_tpu_torch.models.distributions import Distribution  # noqa: F401
from probabilit_tpu_torch.models.graph import Exp, Log, Sign  # noqa: F401

__all__ = [
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Lognormal",
    "PERT",
    "Triangular",
    "ClaytonCopula",
    "GumbelCopula",
    "FrankCopula",
    "GaussianCopula",
    "TCopula",
    "EmpiricalCopula",
]
