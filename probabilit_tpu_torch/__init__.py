"""probabilit_tpu_torch: the PyTorch and CUDA port of probabilit-tpu.

Graph-based Monte Carlo modeling (lazy graphs of distributions, constants
and transforms, sampled by inverse CDF) on PyTorch, with the whole
sampling pass of a graph in one CUDA kernel generated from hand-written
device code for the H100
(``executor="cuda"``), quasi-Monte Carlo and antithetic ``method=``
sampling, copula and multivariate nodes, streamed
``estimate``/``estimate_many``/``sample_streaming`` at any sample count,
pathwise parameter gradients (``sensitivity``, ``torch.autograd`` through
the plain executor) and Sobol' indices (``sobol_indices``), scenario
ladders (``sweep``), quantile-space importance tilting (``tilted``,
``suggest_tilt``), multilevel Monte Carlo (``mlmc_estimate``),
Longstaff-Schwartz American exercise (``american_price``,
``american_greeks``),
scalar Python functions as nodes (``scalar_transform``), path processes
(Brownian, GBM, OU, Poisson, Merton, Lévy, CIR, Heston, SDE, Markov and
the joint multi-asset paths, ``models/processes.py``), and a hand-written
bitonic row sort
(``ops/bitonic_sort.py``).  The JAX package ``probabilit_tpu`` is the
reference the port is tested against; this package never imports it or
JAX.  Importing it compiles nothing: the kernel is built at first use.
"""

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine.american import american_greeks, american_price
from probabilit_tpu_torch.inspection import plot
from probabilit_tpu_torch.engine.sampler import sample, sample_from_quantiles
from probabilit_tpu_torch.engine.sensitivity import (
    SensitivityResult,
    SobolIndices,
    sensitivity,
    sobol_indices,
)
from probabilit_tpu_torch.engine.importance import suggest_tilt, tilted, wide_families
from probabilit_tpu_torch.engine.mlmc import mlmc_estimate
from probabilit_tpu_torch.engine.streaming import estimate, estimate_many, sample_streaming
from probabilit_tpu_torch.engine.sweep import SweepResult, sweep
from probabilit_tpu_torch.models.distributions import (
    CumulativeDistribution,
    DiscreteDistribution,
    Distribution,
    EmpiricalDistribution,
    MultivariateDistribution,
    QuantileTransform,
)
from probabilit_tpu_torch.models.factories import (
    PERT,
    ClaytonCopula,
    EmpiricalCopula,
    FrankCopula,
    GaussianCopula,
    GumbelCopula,
    Lognormal,
    Normal,
    Triangular,
    TCopula,
    TruncatedNormal,
    Uniform,
)
from probabilit_tpu_torch.models.levy import NormalInverseGaussian, VarianceGamma
from probabilit_tpu_torch.models.markov import MarkovChain, RegimeSwitchingGBM
from probabilit_tpu_torch.models.processes import (
    BrownianMotion,
    CorrelatedGBM,
    CorrelatedMerton,
    GeometricBrownianMotion,
    MertonJumpDiffusion,
    OrnsteinUhlenbeck,
    PathDistribution,
    PathFunctional,
    PoissonProcess,
)
from probabilit_tpu_torch.models.sde import SDE
from probabilit_tpu_torch.models.stochvol import CorrelatedHeston, CoxIngersollRoss, Heston
from probabilit_tpu_torch.models.graph import (
    Abs,
    Add,
    All,
    Any,
    Arccos,
    Arccosh,
    Arcsin,
    Arcsinh,
    Arctan,
    Arctan2,
    Arctanh,
    Avg,
    Ceil,
    Constant,
    Cos,
    Cosh,
    Divide,
    Equal,
    Exp,
    Expm1,
    Floor,
    FloorDivide,
    GreaterThan,
    GreaterThanOrEqual,
    IsClose,
    LessThan,
    LessThanOrEqual,
    Log,
    Log10,
    Log1p,
    Max,
    Min,
    Mod,
    Multiply,
    Negate,
    NoOp,
    NotEqual,
    Power,
    ScalarFunctionTransform,
    Sign,
    Sin,
    Sinh,
    Sqrt,
    Square,
    Subtract,
    Tan,
    Tanh,
    scalar_transform,
)

__version__ = "0.1.0"

__all__ = [
    "config",
    "plot",
    "sample",
    "sample_from_quantiles",
    "estimate",
    "estimate_many",
    "sample_streaming",
    "sensitivity",
    "sobol_indices",
    "SensitivityResult",
    "SobolIndices",
    "sweep",
    "SweepResult",
    "tilted",
    "suggest_tilt",
    "wide_families",
    "mlmc_estimate",
    "american_price",
    "american_greeks",
    "Distribution",
    "EmpiricalDistribution",
    "CumulativeDistribution",
    "DiscreteDistribution",
    "MultivariateDistribution",
    "QuantileTransform",
    "ClaytonCopula",
    "GumbelCopula",
    "FrankCopula",
    "GaussianCopula",
    "TCopula",
    "EmpiricalCopula",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Lognormal",
    "PERT",
    "Triangular",
    "Constant",
    "scalar_transform",
    "ScalarFunctionTransform",
    "Add",
    "Multiply",
    "Max",
    "Min",
    "All",
    "Any",
    "Avg",
    "NoOp",
    "FloorDivide",
    "Mod",
    "Divide",
    "Power",
    "Subtract",
    "Equal",
    "NotEqual",
    "LessThan",
    "LessThanOrEqual",
    "GreaterThan",
    "GreaterThanOrEqual",
    "IsClose",
    "Arctan2",
    "Negate",
    "Abs",
    "Log",
    "Exp",
    "Floor",
    "Ceil",
    "Sign",
    "Sqrt",
    "Square",
    "Log10",
    "Sin",
    "Cos",
    "Tan",
    "Arcsin",
    "Arccos",
    "Arctan",
    "Sinh",
    "Cosh",
    "Tanh",
    "Arcsinh",
    "Arccosh",
    "Arctanh",
    "Log1p",
    "Expm1",
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "CorrelatedMerton",
    "VarianceGamma",
    "NormalInverseGaussian",
    "CoxIngersollRoss",
    "Heston",
    "CorrelatedHeston",
    "SDE",
    "MarkovChain",
    "RegimeSwitchingGBM",
    "PathDistribution",
    "PathFunctional",
]
