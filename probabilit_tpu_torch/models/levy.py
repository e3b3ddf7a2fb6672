"""Pure-jump Lévy path nodes: Variance Gamma and Normal Inverse Gaussian.

Port of ``probabilit_tpu/models/levy.py``.  Both families are Brownian
motions with drift run on an independent random clock, and both clocks
have inverse CDFs in the port (``ops/ppf.py``: ``gamma`` and ``invgauss``,
Newton ppfs).  A Lévy process has iid increments whose law is known at
every time scale, so the grid path is exact:

* Variance Gamma (Madan-Carr-Chang 1998): the increment over ``dt`` is
  ``mu dt + theta G + sigma sqrt(G) Z`` with ``G ~ Gamma(shape = dt/nu,
  scale = nu)``;
* Normal Inverse Gaussian (Barndorff-Nielsen 1997): ``mu dt + beta I +
  sqrt(I) Z`` with ``I ~ IG(mean = delta dt / g, shape = (delta dt)^2)``,
  ``g = sqrt(alpha^2 - beta^2)``, which is scipy's ``invgauss(mu = 1/(g
  delta dt), scale = (delta dt)^2)``.

One inverse-CDF transform for the clock, one normal draw, an elementwise
combine and a ``cumsum``; no rejection loops.  Randomness follows the
path-node contract (``models/processes.py``): a column-keyed generator,
or a slab of clock uniforms then conditional normals.

>>> vg = VarianceGamma(theta=-0.1, sigma=0.2, nu=0.2, T=1.0, steps=4)
>>> vg.terminal()
PathFunctional(VGPath(mu=0, theta=-0.1, sigma=0.2, nu=0.2, T=1, steps=4), 'terminal')
"""

from __future__ import annotations

import math

import torch

from probabilit_tpu_torch.models.processes import PathDistribution, normal, time_cumsum, uniform
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import special as _special

__all__ = ["VarianceGamma", "NormalInverseGaussian", "VGPath", "NIGPath"]


class _SubordinatedPath(PathDistribution):
    """A Brownian motion on a random clock: ``_clock`` maps uniforms to
    clock increments and ``_combine`` the clock and normals to the path's
    increments."""

    @property
    def _q_width(self):
        # Two drivers a step: the clock's uniform and the conditional
        # normal.
        return 2 * self.steps

    def _increments(self, gen, n, dtype):
        shape = (n, self.steps)
        u = uniform(gen, shape, dtype)
        z = normal(gen, shape, dtype)
        return self._combine(self._clock(u, dtype), z)

    def _increments_from_slab(self, slab, dtype):
        # The clock's uniforms take the leading columns (the clock carries
        # the tails); no bridge: each increment's clock is its own
        # dimension.
        s = self.steps
        clock = self._clock(slab[:, :s], dtype)
        z = _special.ndtri_fast(slab[:, s:].to(dtype))
        return self._combine(clock, z)

    def _path_from_increments(self, inc):
        return time_cumsum(inc)


class VGPath(_SubordinatedPath):
    """Variance-Gamma Lévy path, exact iid increments at any ``dt``.

    ``X_t = mu t + theta G_t + sigma W(G_t)`` with a gamma clock of unit
    mean rate and variance rate ``nu``.  Per unit time: mean ``mu +
    theta``, variance ``sigma^2 + nu theta^2``.
    """

    # nu shapes the clock's law (shape dt/nu): no pathwise derivative.
    _param_slots = ("mu", "theta", "sigma")

    def __init__(self, mu=0.0, theta=0.0, sigma=0.2, nu=0.2, T=1.0, steps=252):
        sigma, nu = float(sigma), float(nu)
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        if not nu > 0:
            raise ValueError(f"nu must be positive, got {nu}.")
        self.mu = float(mu)
        self.theta = float(theta)
        self.sigma = sigma
        self.nu = nu
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"VGPath(mu={self.mu:g}, theta={self.theta:g}, "
            f"sigma={self.sigma:g}, nu={self.nu:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return ("VGPath", self.mu, self.theta, self.sigma, self.nu, self.T, self.steps)

    def _clock(self, u, dtype):
        """Gamma clock increments (shape dt/nu, scale nu) of uniforms."""
        dt = self.T / self.steps
        return self.nu * _ppf.call("gamma", u.to(dtype), a=dt / self.nu).to(dtype)

    def _combine(self, g, z):
        dt = self.T / self.steps
        return self.mu * dt + self.theta * g + self.sigma * torch.sqrt(g) * z


class NIGPath(_SubordinatedPath):
    """Normal-Inverse-Gaussian Lévy path, exact iid increments.

    Barndorff-Nielsen's ``(alpha, beta, delta, mu)`` with ``alpha >
    |beta|``: over any horizon ``t`` the increment is ``NIG(alpha, beta,
    delta t, mu t)``.  Per unit time: mean ``mu + delta beta / g``,
    variance ``delta alpha^2 / g^3``, ``g = sqrt(alpha^2 - beta^2)``.
    """

    # alpha, beta and delta shape the clock's law; only the drift has a
    # pathwise derivative.
    _param_slots = ("mu",)

    def __init__(self, alpha=1.0, beta=0.0, delta=1.0, mu=0.0, T=1.0, steps=252):
        alpha, beta, delta = float(alpha), float(beta), float(delta)
        if not alpha > 0:
            raise ValueError(f"alpha must be positive, got {alpha}.")
        if not abs(beta) < alpha:
            raise ValueError(f"NIG needs |beta| < alpha, got beta={beta}, alpha={alpha}.")
        if not delta > 0:
            raise ValueError(f"delta must be positive, got {delta}.")
        self.alpha = alpha
        self.beta = beta
        self.delta = delta
        self.mu = float(mu)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"NIGPath(alpha={self.alpha:g}, beta={self.beta:g}, "
            f"delta={self.delta:g}, mu={self.mu:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return ("NIGPath", self.alpha, self.beta, self.delta, self.mu, self.T, self.steps)

    def _clock(self, u, dtype):
        """Inverse-Gaussian clock increments of uniforms: IG(mean m, shape
        L), ``m = delta dt / g``, ``L = (delta dt)^2``, which is scipy's
        ``invgauss(mu = m / L, scale = L)``."""
        dt = self.T / self.steps
        g = math.sqrt(self.alpha**2 - self.beta**2)
        ddt = self.delta * dt
        return _ppf.call("invgauss", u.to(dtype), mu=1.0 / (g * ddt), scale=ddt * ddt).to(dtype)

    def _combine(self, clock, z):
        dt = self.T / self.steps
        return self.mu * dt + self.beta * clock + torch.sqrt(clock) * z


def VarianceGamma(mu=0.0, theta=0.0, sigma=0.2, nu=0.2, T=1.0, steps=252):
    """Variance-Gamma Lévy path node; see :class:`VGPath`.

    >>> VarianceGamma(theta=-0.1, sigma=0.2, nu=0.2, steps=4)
    VGPath(mu=0, theta=-0.1, sigma=0.2, nu=0.2, T=1, steps=4)
    """
    return VGPath(mu=mu, theta=theta, sigma=sigma, nu=nu, T=T, steps=steps)


def NormalInverseGaussian(alpha=1.0, beta=0.0, delta=1.0, mu=0.0, T=1.0, steps=252):
    """Normal-Inverse-Gaussian Lévy path node; see :class:`NIGPath`.

    >>> NormalInverseGaussian(alpha=2.0, beta=-0.5, delta=0.8, steps=4)
    NIGPath(alpha=2, beta=-0.5, delta=0.8, mu=0, T=1, steps=4)
    """
    return NIGPath(alpha=alpha, beta=beta, delta=delta, mu=mu, T=T, steps=steps)
