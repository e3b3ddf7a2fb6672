"""Copula samplers (Clayton, Gumbel, Frank; Gaussian, Student-t;
empirical), in PyTorch.

Port of ``probabilit_tpu/ops/copulas.py:57-401``.  The Archimedean
families sample by the Marshall-Olkin (frailty) construction

    U_k = psi(E_k / V),   E_k ~ iid Exp(1),   V ~ the frailty law,

one frailty draw per observation and one exponential per coordinate, no
rejection loop and no sort:

* Clayton  psi(t) = (1+t)^(-1/theta), V ~ Gamma(1/theta) (half-integer
  shapes through the loop-free ``special.chi2_draws``, others through
  ``torch._standard_gamma``), tau = theta / (theta + 2);
* Gumbel   psi(t) = exp(-t^(1/theta)), V ~ positive stable(1/theta) by
  Chambers-Mallows-Stuck, tau = 1 - 1/theta;
* Frank    psi(t) = -log1p(-p e^(-t)) / theta, V ~ Logarithmic(p) by
  Kemp's LK algorithm, p = 1 - e^(-theta); theta < 0 (bivariate only)
  samples by conditional inversion.

The elliptical copulas recolour normals by the Cholesky factor of the
shape matrix (and divide by a shared chi-square mixing for the t); the
empirical copula bootstraps rank pseudo-observations.  Every draw comes
from the node's ``torch.Generator`` (``ops/multivariate._key_from_q``),
so the draws differ from the JAX package's jax-key draws by design and
are held to the same laws.  The host-side calibration and validation
(``theta_from_tau``, ``rho_from_tau``, ``corr_cholesky``, ``validate*``,
``empirical_pseudo_observations``) are numpy and scipy, as in the JAX
package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from probabilit_tpu_torch.ops import special as _special
from probabilit_tpu_torch.ops.qmc import clamp_open_unit

__all__ = [
    "sample",
    "validate",
    "FAMILIES",
    "ELLIPTICAL_FAMILIES",
    "corr_cholesky",
    "validate_elliptical",
    "elliptical_sample",
    "theta_from_tau",
    "rho_from_tau",
    "empirical_pseudo_observations",
    "empirical_sample",
]

FAMILIES = ("clayton", "gumbel", "frank")
ELLIPTICAL_FAMILIES = ("gaussian", "t")


def validate(family, theta, d):
    """Raise ValueError unless (family, theta, d) is a supported combo."""
    if family not in FAMILIES:
        raise ValueError(f"Unknown copula family {family!r}; expected one of {FAMILIES}.")
    theta = float(theta)
    d = int(d)
    if d < 2:
        raise ValueError(f"A copula needs d >= 2 dimensions, got {d}.")
    if family == "clayton" and not theta > 0:
        raise ValueError(f"Clayton requires theta > 0, got {theta}.")
    if family == "gumbel" and not theta >= 1:
        raise ValueError(f"Gumbel requires theta >= 1, got {theta}.")
    if family == "frank":
        if theta == 0.0:
            raise ValueError("Frank theta=0 is independence; use independent uniforms.")
        if theta < 0.0 and d != 2:
            # Negative dependence exists only in the bivariate Frank.
            raise ValueError(f"Frank theta < 0 is bivariate-only (got d={d}).")
        if theta < -30.0:
            # The conditional form evaluates e^(-theta u): float32 overflows.
            raise ValueError(f"Frank theta must be >= -30 (float32 range), got {theta}.")
    return theta, d


def _uniform(gen, shape, dtype, device):
    return clamp_open_unit(torch.rand(shape, generator=gen, dtype=dtype, device=device))


def _exp1(gen, shape, dtype, device):
    """iid Exp(1) draws, strictly positive."""
    return -torch.log(_uniform(gen, shape, dtype, device))


def _positive_stable(gen, shape, alpha, dtype, device):
    """One-sided stable S(alpha) with Laplace transform exp(-s^alpha), by
    Chambers-Mallows-Stuck (the Gumbel frailty; alpha < 1):

        S = (sin(alpha u) / (sin u)^(1/alpha))
            * (sin((1-alpha) u) / w)^((1-alpha)/alpha)

    with u ~ U(0, pi), w ~ Exp(1)."""
    u = _uniform(gen, shape, dtype, device) * math.pi
    w = _exp1(gen, shape, dtype, device)
    a = alpha
    return (torch.sin(a * u) / _special.pow(torch.sin(u), 1.0 / a)) * _special.pow(
        torch.sin((1.0 - a) * u) / w, (1.0 - a) / a
    )


def _log_series(gen, shape, log1mp, dtype, device):
    """Logarithmic(p) draws (as floats >= 1), Kemp's LK algorithm in a
    branch-free form, parameterised by ``log1mp = log(1 - p)`` (exact for
    the Frank frailty: ``-theta``), because ``p = 1 - e^(-theta)`` rounds
    to 1 in float32 from theta ~16.6 on."""
    u1 = _uniform(gen, shape, dtype, device)
    u2 = _uniform(gen, shape, dtype, device)
    # q = 1 - (1-p)^u1, and log(q) from log1p of the small complement.
    q = -torch.expm1(u1 * log1mp)
    comp = torch.clamp(torch.exp(u1 * log1mp), min=torch.finfo(dtype).tiny)
    log_q = torch.log1p(-comp)
    heavy = torch.floor(1.0 + torch.log(u2) / log_q)
    one = torch.ones((), dtype=dtype, device=device)
    v = torch.where(u2 < q * q, heavy, torch.where(u2 > q, one, 2.0 * one))
    return torch.clamp(v, min=1.0)


def sample(family, gen, shape, theta, dtype, device):
    """(n, d) copula draws from ``gen``: uniform marginals, ``family``
    dependence."""
    n, d = shape
    theta, d = validate(family, theta, d)
    tiny = torch.finfo(dtype).tiny
    if family == "frank" and theta < 0.0:
        # Bivariate negative dependence by conditional inversion:
        # u2 = -(1/theta) log1p(v (1-e^-theta) / (v expm1(-theta u1) - e^(-theta u1))).
        u1 = _uniform(gen, (n,), dtype, device)
        v = _uniform(gen, (n,), dtype, device)
        e1 = torch.exp(-theta * u1)
        denom = v * torch.expm1(-theta * u1) - e1
        ratio = v * (-math.expm1(-theta)) / denom
        u2 = -torch.log1p(ratio) / theta
        return clamp_open_unit(torch.stack([u1, u2], dim=1))
    E = _exp1(gen, (n, d), dtype, device)
    if family == "clayton":
        # V ~ Gamma(1/theta); psi through exp/log1p keeps weak dependence
        # (theta near 0) accurate.  Half-integer shapes take the loop-free
        # chi-square decomposition.
        alpha = 1.0 / theta
        if (2.0 * alpha).is_integer() and 1.0 <= 2.0 * alpha <= 128.0:
            V = 0.5 * _special.chi2_draws(gen, 2.0 * alpha, n, dtype, device)[:, None]
        else:
            shape_param = torch.full((n, 1), alpha, dtype=dtype, device=device)
            V = torch._standard_gamma(shape_param, generator=gen)
        V = torch.clamp(V, min=tiny)
        u = torch.exp(-torch.log1p(E / V) / theta)
    elif family == "gumbel":
        if theta == 1.0:
            u = torch.exp(-E)  # independence: the stable law degenerates
        else:
            V = _positive_stable(gen, (n, 1), 1.0 / theta, dtype, device)
            u = torch.exp(-_special.pow(E / V, 1.0 / theta))
    else:  # frank, positive dependence (frailty; any dimension)
        p = -math.expm1(-theta)
        V = _log_series(gen, (n, 1), -theta, dtype, device)
        t = E / V
        # For large theta V is huge and t tiny, where exp(-t) loses every
        # digit: small t takes 1 - p e^(-t) = -expm1(-t) + e^(-t-theta),
        # each term exact; large t takes log1p directly.
        bracket_small = -torch.expm1(-t) + torch.exp(-t - theta)
        u = torch.where(
            t < 0.6931,
            -torch.log(torch.clamp(bracket_small, min=tiny)) / theta,
            -torch.log1p(-p * torch.exp(-t)) / theta,
        )
    return clamp_open_unit(u)


def theta_from_tau(family, tau):
    """Invert Kendall's tau to the family's ``theta`` (host, closed form;
    Frank by bisection of its Debye expression to 1e-10).

    >>> round(theta_from_tau("clayton", 0.5), 6)
    2.0
    >>> round(theta_from_tau("gumbel", 0.5), 6)
    2.0
    """
    tau = float(tau)
    if family not in FAMILIES:
        raise ValueError(f"Unknown copula family {family!r}; expected one of {FAMILIES}.")
    if family == "frank" and -1.0 < tau < 0.0:
        # Frank's tau is odd in theta; the sampler covers theta >= -30.
        theta = -theta_from_tau("frank", -tau)
        if theta < -30.0:
            raise ValueError(
                f"tau={tau} needs Frank theta={theta:.2f}, below the "
                "sampler's float32 floor of -30 (tau >= ~-0.874); no "
                "Frank copula this negative can be sampled here."
            )
        return theta
    if family == "frank" and not -1.0 < tau < 1.0:
        raise ValueError(f"Frank tau must be in (-1, 1), got {tau}.")
    if not 0.0 < tau < 1.0:
        raise ValueError(f"tau must be in (0, 1) for the frailty families, got {tau}.")
    if family == "clayton":
        return 2.0 * tau / (1.0 - tau)
    if family == "gumbel":
        return 1.0 / (1.0 - tau)
    from scipy.integrate import quad

    def tau_of(theta):
        d1 = quad(lambda t: t / np.expm1(t), 0.0, theta)[0] / theta
        return 1.0 - 4.0 / theta * (1.0 - d1)

    lo, hi = 1e-6, 1.0
    while tau_of(hi) < tau:
        hi *= 2.0
        if hi > 1e6:
            raise ValueError(f"tau={tau} is out of Frank's invertible range.")
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if tau_of(mid) < tau:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-10 * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def rho_from_tau(tau):
    """Elliptical-copula shape from Kendall's tau: ``rho = sin(pi tau / 2)``
    (every elliptical copula).

    >>> round(rho_from_tau(0.5), 6)
    0.707107
    """
    tau = float(tau)
    if not -1.0 < tau < 1.0:
        raise ValueError(f"tau must be in (-1, 1), got {tau}.")
    return float(np.sin(np.pi * tau / 2.0))


def corr_cholesky(corr, min_d=2):
    """Validated (chol, d) of a correlation matrix: square, d >= min_d,
    unit diagonal, symmetric, positive definite."""
    corr = np.asarray(corr, np.float64)
    if corr.ndim != 2 or corr.shape[0] != corr.shape[1] or corr.shape[0] < min_d:
        raise ValueError(f"corr must be square with d >= {min_d}, got {corr.shape}.")
    if not np.allclose(np.diag(corr), 1.0):
        raise ValueError("corr must have unit diagonal.")
    if not np.allclose(corr, corr.T):
        raise ValueError("corr must be symmetric.")
    try:
        chol = np.linalg.cholesky(corr)
    except np.linalg.LinAlgError:
        raise ValueError("corr must be positive definite.") from None
    return chol, corr.shape[0]


def validate_elliptical(family, corr, df):
    """(chol, d, df) for an elliptical copula, or raise ValueError."""
    if family not in ELLIPTICAL_FAMILIES:
        raise ValueError(
            f"Unknown elliptical family {family!r}; expected one of {ELLIPTICAL_FAMILIES}."
        )
    chol, d = corr_cholesky(corr)
    if family == "t":
        df = float(df)
        if not df > 0:
            raise ValueError(f"t copula needs df > 0, got {df}.")
    elif df is not None:
        raise ValueError("df applies to the t copula only.")
    return chol, d, df


def elliptical_sample(family, gen, n, chol, df, dtype, device):
    """(n, d) elliptical-copula draws: uniform marginals, shape ``chol``.
    Gaussian: ``u = Phi(z)`` of the recoloured normals; Student-t divides
    by a shared ``sqrt(chi2(df)/df)`` per row first and maps through the
    t CDF."""
    d = chol.shape[0]
    z = torch.randn((n, d), generator=gen, dtype=dtype, device=device)
    z = z @ torch.as_tensor(chol.T, dtype=dtype, device=device)
    if family == "gaussian":
        u = _special.ndtr_fast(z)
    else:
        mix = torch.sqrt(_special.chi2_draws(gen, df, n, dtype, device) / df)
        u = _special.t_cdf(z / mix[:, None], df)
    return clamp_open_unit(u)


def empirical_pseudo_observations(data):
    """(m, d) pseudo-observations rank(x)/(m+1) of observed rows (average
    ranks for ties), each column strictly inside (0, 1)."""
    from scipy.stats import rankdata

    data = np.asarray(data, np.float64)
    if data.ndim != 2 or data.shape[1] < 2:
        raise ValueError(f"data must be (observations, d >= 2), got {data.shape}.")
    if data.shape[0] < 2:
        raise ValueError("Need at least two observations.")
    if not np.isfinite(data).all():
        raise ValueError("data must be finite.")
    m = data.shape[0]
    return rankdata(data, axis=0) / (m + 1.0)


def empirical_sample(gen, n, pseudo, dtype, device):
    """(n, d) draws with the empirical dependence of ``pseudo``: a bootstrap
    of its rows (one row gather)."""
    m = pseudo.shape[0]
    idx = torch.randint(0, m, (n,), generator=gen, device=device)
    return torch.as_tensor(np.asarray(pseudo), dtype=dtype, device=device)[idx]
