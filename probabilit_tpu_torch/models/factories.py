"""Named distribution factories with friendly parametrizations.

Port of ``probabilit_tpu/models/factories.py:35-188``: thin
re-parametrizations on top of
:class:`~probabilit_tpu_torch.models.distributions.Distribution`.  The
``Lognormal`` parameters are themselves graph expressions, so composite
distributions work; the ``Triangular`` percentile fit is a damped Newton
solve on the triangular CDF, in numpy; and (``:191-295``) the copula
factories, each returning the ``MarginalDistribution`` slices of one
copula node.
"""

from __future__ import annotations

import warnings

import numpy as np

from probabilit_tpu_torch.models.distributions import Distribution
from probabilit_tpu_torch.models.graph import Exp, Log, Sign

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


def Uniform(min=0, max=1):
    """Uniform distribution on [min, max)."""
    return Distribution("uniform", loc=min, scale=max - min)


def Normal(loc, scale):
    """Normal distribution parametrized by mean (loc) and std (scale)."""
    return Distribution("norm", loc=loc, scale=scale)


def TruncatedNormal(loc, scale, low, high):
    """Truncated Normal with mean ``loc`` / std ``scale`` on [low, high)."""
    a, b = (low - loc) / scale, (high - loc) / scale
    return Distribution("truncnorm", a=a, b=b, loc=loc, scale=scale)


class Lognormal(Distribution):
    """Lognormal parametrized by the mean/std of the lognormal itself.

    The moment-matching transform is built from graph nodes, so ``mean``
    and ``std`` may be distributions (reference ``distributions.py:32-75``).
    """

    def __init__(self, mean, std):
        # Sign-preserving square: a negative std stays negative and is
        # rejected downstream by the lognorm parameter validation.
        variance = Sign(std) * std**2
        sigma_squared = Log(1 + variance / (mean**2))
        sigma = (sigma_squared) ** (1 / 2)
        mu = Log(mean) - sigma_squared / 2
        super().__init__(distr="lognorm", s=sigma, scale=Exp(mu))

    @classmethod
    def from_log_params(cls, mu, sigma):
        """Lognormal from the mean/std of the underlying normal (log-space)."""
        return Distribution("lognorm", s=sigma, scale=Exp(mu))


def _pert_to_beta(minimum, mode, maximum, gamma=4.0):
    """Convert the PERT parametrization to beta (a, b, loc, scale).

    >>> _pert_to_beta(0, 3/4, 1)
    (4.0, 2.0, 0, 1)
    """
    if not (minimum < mode < maximum):
        raise ValueError(f"Must have {minimum=} < {mode=} < {maximum=}")
    if gamma <= 0:
        raise ValueError(f"Gamma must be positive, got {gamma=}")
    loc = minimum
    scale = maximum - minimum
    a = 1 + gamma * (mode - minimum) / scale
    b = 1 + gamma * (maximum - mode) / scale
    return (a, b, loc, scale)


def PERT(minimum, mode, maximum, gamma=4.0):
    """Beta distribution parameterized by PERT parameters.

    >>> PERT(0, 6, 10)
    Distribution("beta", a=3.4, b=2.6, loc=0, scale=10)
    """
    a, b, loc, scale = _pert_to_beta(minimum, mode, maximum, gamma=gamma)
    return Distribution("beta", a=a, b=b, loc=loc, scale=scale)


def _triangular_cdf(x, a, b, mode):
    """CDF of a triangular distribution with support [a, b] and given mode."""
    if x <= a:
        return 0.0
    if x >= b:
        return 1.0
    if x <= mode:
        return (x - a) ** 2 / ((b - a) * (mode - a))
    return 1.0 - (b - x) ** 2 / ((b - a) * (b - mode))


def _fit_triangular_distribution(low, mode, high, low_perc=0.10, high_perc=0.90):
    """Fit (loc, scale, c) so CDF(low)=low_perc and CDF(high)=high_perc.

    Damped Newton on the two-equation system with a numeric Jacobian
    (reference solves the same system with fsolve,
    ``distributions.py:137-184``).

    >>> tuple(round(v, 2) for v in _fit_triangular_distribution(3, 8, 10))
    (-0.21, 12.54, 0.65)
    """

    def residual(params):
        a, b = params
        return np.array(
            [
                _triangular_cdf(low, a, b, mode) - low_perc,
                _triangular_cdf(high, a, b, mode) - high_perc,
            ]
        )

    x = np.array([low - abs(mode - low), high + abs(high - mode)], dtype=float)
    h = 1e-6 * max(1.0, high - low)
    for _ in range(200):
        r = residual(x)
        if np.max(np.abs(r)) < 1e-12:
            break
        J = np.empty((2, 2))
        for j in range(2):
            step = np.zeros(2)
            step[j] = h
            J[:, j] = (residual(x + step) - residual(x - step)) / (2 * h)
        try:
            delta = np.linalg.solve(J, r)
        except np.linalg.LinAlgError:
            break
        # Damping: keep a < mode < b at all times.
        scale_step = 1.0
        for _ in range(30):
            trial = x - scale_step * delta
            if trial[0] < mode < trial[1]:
                break
            scale_step /= 2.0
        x = x - scale_step * delta

    a, b = x
    rmse = float(np.sqrt(np.sum(residual(x) ** 2)))
    if rmse > 1e-6:
        warnings.warn(f"Optimization of Triangular params has {rmse=}")
    c = (mode - a) / (b - a)
    return float(a), float(b - a), float(c)


def Triangular(low, mode, high, low_perc=0.1, high_perc=0.9):
    """Triangular distribution fit to (low, mode, high) percentiles.

    Arguments must be numbers (no composite support), reference
    ``distributions.py:97-134``.

    >>> Triangular(low=1, mode=5, high=9, low_perc=0, high_perc=1)
    Distribution("triang", loc=1, scale=8, c=0.5)
    """
    if not (low < mode < high):
        raise ValueError(f"Must have {low=} < {mode=} < {high=}")
    if not ((0 <= low_perc <= 1.0) and (0 <= high_perc <= 1.0)):
        raise ValueError("Percentiles must be between 0 and 1.")
    # Stricter than the reference (which only range-checks): inverted
    # percentiles make the Newton fit diverge to a garbage distribution
    # with nothing but an RMSE warning — refuse them up front.
    if not (low_perc < high_perc):
        raise ValueError(f"Must have {low_perc=} < {high_perc=}")

    if np.isclose(low_perc, 0.0) and np.isclose(high_perc, 1.0):
        loc, scale, c = low, high - low, (mode - low) / (high - low)
    else:
        loc, scale, c = _fit_triangular_distribution(
            low=low, mode=mode, high=high, low_perc=low_perc, high_perc=high_perc
        )
    return Distribution("triang", loc=loc, scale=scale, c=c)


def _copula(family, theta, d):
    from probabilit_tpu_torch.models.distributions import CopulaDistribution, MarginalDistribution

    node = CopulaDistribution(family, theta=theta, d=d)
    return tuple(MarginalDistribution(node, d=i) for i in range(d))


def _slices(node):
    from probabilit_tpu_torch.models.distributions import MarginalDistribution

    return tuple(MarginalDistribution(node, d=i) for i in range(node.d))


def ClaytonCopula(theta, d=2):
    """``d`` dependent Uniform(0,1) nodes with Clayton-copula dependence:
    lower-tail dependent (``lambda_L = 2^(-1/theta)``), Kendall's
    ``tau = theta / (theta + 2)``.  Shape the marginals with
    ``QuantileTransform``.

    >>> u1, u2 = ClaytonCopula(theta=2.0)
    >>> u1
    MarginalDistribution(CopulaDistribution("clayton", theta=2, d=2), d=0)
    """
    return _copula("clayton", theta, d)


def GumbelCopula(theta, d=2):
    """``d`` dependent Uniform(0,1) nodes with Gumbel-copula dependence:
    upper-tail dependent (``lambda_U = 2 - 2^(1/theta)``), ``tau = 1 -
    1/theta``; ``theta=1`` is independence."""
    return _copula("gumbel", theta, d)


def FrankCopula(theta, d=2):
    """``d`` dependent Uniform(0,1) nodes with Frank-copula dependence:
    tail-free and radially symmetric; ``theta > 0`` for any ``d``, and
    ``-30 <= theta < 0`` (negative dependence) for ``d = 2``."""
    return _copula("frank", theta, d)


def GaussianCopula(corr):
    """d dependent Uniform(0,1) nodes with Gaussian-copula dependence on the
    shape matrix ``corr`` (calibrate from rank data with
    ``ops.copulas.rho_from_tau``); no tail dependence."""
    from probabilit_tpu_torch.models.distributions import EllipticalCopulaDistribution

    return _slices(EllipticalCopulaDistribution("gaussian", corr))


def TCopula(corr, df=4.0):
    """d dependent Uniform(0,1) nodes with Student-t copula dependence:
    symmetric tail dependence ``2 t_{df+1}(-sqrt((df+1)(1-rho)/(1+rho)))``
    at shape ``rho``."""
    from probabilit_tpu_torch.models.distributions import EllipticalCopulaDistribution

    return _slices(EllipticalCopulaDistribution("t", corr, df=df))


def EmpiricalCopula(data):
    """d dependent nodes with the rank dependence of ``data`` (an
    ``(observations, d)`` array): a bootstrap of its rank
    pseudo-observations, no parametric family assumed."""
    from probabilit_tpu_torch.models.distributions import EmpiricalCopulaDistribution

    return _slices(EmpiricalCopulaDistribution(data))
