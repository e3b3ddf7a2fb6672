"""Square-root-diffusion nodes: CIR variance paths and the Heston model.

Port of ``probabilit_tpu/models/stochvol.py``.  The Cox-Ingersoll-Ross
process has a closed-form transition, a scaled noncentral chi-square, so
its grid path is sampled exactly, with no Euler error and no truncation
near zero:

    V_{k+1} | V_k  =  c * ncx2(df, V_k * e / c),      e = exp(-kappa dt),
    c = sigma^2 (1 - e) / (4 kappa),   df = 4 kappa theta / sigma^2.

The noncentral chi-square is ``(Z + sqrt(lambda))^2 + Y`` with ``Z ~
N(0, 1)`` and ``Y ~ chi2(df - 1)`` (valid for ``df > 1``).  Both driver
matrices are drawn before the time loop (the chi-square through the
port's ``chi2`` inverse CDF, a Newton ppf), so the loop over the steps is
four elementwise ops on an ``(n,)`` carry.

The Heston asset rides the exact variance path with Andersen's broken
scheme (Andersen 2008, eq. 33): the integrated variance of a step is the
trapezoid ``dt (V_k + V_{k+1}) / 2``, the variance's Brownian integral is
recovered exactly from the CIR dynamics, and the log-asset increment is
Gaussian given the variance path with the leverage ``rho``.  Variance
marginals are exact at every grid time.

Randomness follows the path-node contract (``models/processes.py``).

>>> v = CoxIngersollRoss(v0=0.04, kappa=2.0, theta=0.04, sigma=0.3)
>>> v.terminal()
PathFunctional(CIRPath(v0=0.04, kappa=2, theta=0.04, sigma=0.3, T=1, steps=252), 'terminal')
"""

from __future__ import annotations

import math

import numpy as np
import torch

from probabilit_tpu_torch.models.processes import (
    JointAssetPaths,
    PathDistribution,
    _recolor_assets,
    _stack_bridged,
    normal,
    time_cumsum,
    sample_major,
    time_major,
    uniform,
)
from probabilit_tpu_torch.ops import bridge as _bridge
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import special as _special

__all__ = [
    "CoxIngersollRoss",
    "Heston",
    "CorrelatedHeston",
    "CIRPath",
    "HestonPath",
    "CorrelatedHestonPaths",
]


def _cir_constants(kappa, theta, sigma, dt):
    """(e, c, df): the exact transition's constants for one step."""
    e = math.exp(-kappa * dt)
    c = sigma * sigma * (1.0 - e) / (4.0 * kappa)
    df = 4.0 * kappa * theta / (sigma * sigma)
    return e, c, df


def _validate_cir(v0, kappa, theta, sigma, what="v0"):
    v0, kappa = float(v0), float(kappa)
    theta, sigma = float(theta), float(sigma)
    if not v0 > 0:
        raise ValueError(f"{what} must be positive, got {v0}.")
    if not kappa > 0:
        raise ValueError(f"kappa must be positive, got {kappa}.")
    if not theta > 0:
        raise ValueError(f"theta must be positive, got {theta}.")
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}.")
    df = 4.0 * kappa * theta / (sigma * sigma)
    if not df > 1.0:
        raise ValueError(
            "Exact CIR sampling needs 4*kappa*theta/sigma^2 > 1 (the "
            "normal + central-chi-square decomposition of the noncentral "
            f"chi-square transition), got {df:.4g}. Increase kappa*theta "
            "or decrease sigma."
        )
    return v0, kappa, theta, sigma


def _cir_drivers_key(gen, n, steps, df, dtype):
    """(z, y) driver matrices from a key-mode generator."""
    z = normal(gen, (n, steps), dtype)
    u = uniform(gen, (n, steps), dtype)
    return z, _ppf.call("chi2", u, df=df - 1.0).to(dtype)


def _cir_drivers_slab(u_z, u_y, df, dtype):
    """(z, y) driver matrices from slab columns.  No bridge: the CIR
    recursion is nonlinear in its innovations, so each step reads its own
    dimension."""
    z = _special.ndtri_fast(u_z.to(dtype))
    y = _ppf.call("chi2", u_y.to(dtype), df=df - 1.0).to(dtype)
    return z, y


def _cir_scan(v0, e, c, z, y):
    """Exact CIR paths from drivers ``z``, ``y`` of shape ``(n, steps,
    ...)``: a loop over dim 1 on an ``(n, ...)`` carry, the noncentrality
    ``V_k e / c`` the only sequential dependence.  ``v0``, ``e`` and ``c``
    are scalars or per-asset vectors along the trailing axis."""
    dtype, device = z.dtype, z.device
    e = torch.as_tensor(e, dtype=dtype, device=device)
    c = torch.as_tensor(c, dtype=dtype, device=device)
    ratio = e / c
    z, y = time_major(z), time_major(y)
    v = torch.broadcast_to(torch.as_tensor(v0, dtype=dtype, device=device), z[0].shape)
    out = torch.empty_like(z)
    for k in range(z.shape[0]):
        shifted = z[k] + torch.sqrt(v * ratio)
        v = c * (shifted * shifted + y[k])
        out[k] = v
    return sample_major(out)


def _andersen_dlog(mu, kappa, theta, sigma, rho, v0, v, zs, dt):
    """Log-asset increments of Andersen's broken scheme given the variance
    path ``v`` (n, steps, ...) and the asset normals ``zs``."""
    v0 = torch.as_tensor(v0, dtype=v.dtype, device=v.device)
    v_prev = torch.cat([torch.broadcast_to(v0, v[:, :1].shape), v[:, :-1]], dim=1)
    integral = (0.5 * dt) * (v_prev + v)
    brownian_v = (v - v_prev - kappa * theta * dt + kappa * integral) / sigma
    # A tensor sqrt: rho may be a tensor that carries a gradient.
    lean = torch.sqrt(torch.as_tensor(1.0 - rho * rho, dtype=v.dtype, device=v.device))
    return mu * dt - 0.5 * integral + rho * brownian_v + lean * torch.sqrt(integral) * zs


class CIRPath(PathDistribution):
    """Cox-Ingersoll-Ross square-root diffusion, exact grid transitions.

    ``dV = kappa (theta - V) dt + sigma sqrt(V) dW`` through the
    noncentral-chi-square transition, so every slice is exact.  Needs
    ``4 kappa theta / sigma^2 > 1``; paths are positive by construction.
    """

    # kappa, theta and sigma shape the chi-square driver's law (df); v0
    # enters only the loop given the drivers.
    _param_slots = ("v0",)

    def __init__(self, v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, T=1.0, steps=252):
        self.v0, self.kappa, self.theta, self.sigma = _validate_cir(v0, kappa, theta, sigma)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"CIRPath(v0={self.v0:g}, kappa={self.kappa:g}, "
            f"theta={self.theta:g}, sigma={self.sigma:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return ("CIRPath", self.v0, self.kappa, self.theta, self.sigma, self.T, self.steps)

    @property
    def _q_width(self):
        # Two drivers a step: the transition's normal and its central
        # chi-square.
        return 2 * self.steps

    def _constants(self):
        return _cir_constants(self.kappa, self.theta, self.sigma, self.T / self.steps)

    def _increments(self, gen, n, dtype):
        _, _, df = self._constants()
        return torch.stack(_cir_drivers_key(gen, n, self.steps, df, dtype), dim=2)

    def _increments_from_slab(self, slab, dtype):
        _, _, df = self._constants()
        s = self.steps
        return torch.stack(_cir_drivers_slab(slab[:, :s], slab[:, s:], df, dtype), dim=2)

    def _path_from_increments(self, inc):
        e, c, _ = self._constants()
        return _cir_scan(self.v0, e, c, inc[:, :, 0], inc[:, :, 1])


class HestonPath(PathDistribution):
    """Heston stochastic-volatility asset path (exact-variance scheme).

    ``dS = mu S dt + sqrt(V) S dW_S``, ``dV = kappa (theta - V) dt + sigma
    sqrt(V) dW_V``, ``corr(dW_S, dW_V) = rho``.  The variance path is exact
    (see :class:`CIRPath`); with ``I_k = dt (V_k + V_{k+1}) / 2`` and
    ``A_k = (V_{k+1} - V_k - kappa theta dt + kappa I_k) / sigma``,

        ln S_{k+1} = ln S_k + mu dt - I_k / 2 + rho A_k
                     + sqrt(1 - rho^2) sqrt(I_k) Z_k .
    """

    # kappa, theta and sigma shape the chi-square driver's law; s0, mu,
    # rho and v0 enter only the path map given the drivers.
    _param_slots = ("s0", "mu", "rho", "v0")

    def __init__(
        self, s0=1.0, mu=0.0, v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, rho=-0.5,
        T=1.0, steps=252,
    ):
        s0, rho = float(s0), float(rho)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not -1.0 < rho < 1.0:
            raise ValueError(f"rho must be in (-1, 1), got {rho}.")
        self.s0 = s0
        self.mu = float(mu)
        self.rho = rho
        self.v0, self.kappa, self.theta, self.sigma = _validate_cir(v0, kappa, theta, sigma)
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"HestonPath(s0={self.s0:g}, mu={self.mu:g}, v0={self.v0:g}, "
            f"kappa={self.kappa:g}, theta={self.theta:g}, "
            f"sigma={self.sigma:g}, rho={self.rho:g}, T={self.T:g}, "
            f"steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "HestonPath", self.s0, self.mu, self.v0, self.kappa, self.theta, self.sigma,
            self.rho, self.T, self.steps,
        )

    @property
    def _q_width(self):
        # Three drivers a step: the asset's normal, the variance's normal
        # and its central chi-square.
        return 3 * self.steps

    def _constants(self):
        return _cir_constants(self.kappa, self.theta, self.sigma, self.T / self.steps)

    def _increments(self, gen, n, dtype):
        _, _, df = self._constants()
        zs = normal(gen, (n, self.steps), dtype)
        zv, y = _cir_drivers_key(gen, n, self.steps, df, dtype)
        return torch.stack([zs, zv, y], dim=2)

    def _increments_from_slab(self, slab, dtype):
        _, _, df = self._constants()
        s = self.steps
        # The asset normals enter a cumulative sum: the leading columns, in
        # bridge order.  The variance drivers read theirs directly.
        zs = _bridge.normal_increments(slab[:, :s], dtype)
        zv, y = _cir_drivers_slab(slab[:, s : 2 * s], slab[:, 2 * s :], df, dtype)
        return torch.stack([zs, zv, y], dim=2)

    def _state_paths_from_increments(self, inc):
        """(asset, variance): the complete per-date Markov state."""
        dt = self.T / self.steps
        e, c, _ = self._constants()
        v = _cir_scan(self.v0, e, c, inc[:, :, 1], inc[:, :, 2])
        dlog = _andersen_dlog(
            self.mu, self.kappa, self.theta, self.sigma, self.rho, self.v0, v, inc[:, :, 0], dt
        )
        return (self.s0 * torch.exp(time_cumsum(dlog)), v)

    def _path_from_increments(self, inc):
        return self._state_paths_from_increments(inc)[0]


def CoxIngersollRoss(v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, T=1.0, steps=252):
    """Exact CIR square-root diffusion path node; see :class:`CIRPath`.

    >>> CoxIngersollRoss(v0=0.03, kappa=2.0, theta=0.04, sigma=0.3, steps=4)
    CIRPath(v0=0.03, kappa=2, theta=0.04, sigma=0.3, T=1, steps=4)
    """
    return CIRPath(v0=v0, kappa=kappa, theta=theta, sigma=sigma, T=T, steps=steps)


def Heston(s0=1.0, mu=0.0, v0=0.04, kappa=1.0, theta=0.04, sigma=0.2, rho=-0.5, T=1.0, steps=252):
    """Heston stochastic-volatility asset path node; see :class:`HestonPath`.

    >>> Heston(s0=100, v0=0.04, kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7,
    ...        steps=4).terminal()
    PathFunctional(HestonPath(s0=100, mu=0, v0=0.04, kappa=2, theta=0.04, sigma=0.3, rho=-0.7, T=1, steps=4), 'terminal')
    """
    return HestonPath(
        s0=s0, mu=mu, v0=v0, kappa=kappa, theta=theta, sigma=sigma, rho=rho, T=T, steps=steps
    )


class CorrelatedHestonPaths(JointAssetPaths):
    """Joint (n, d, steps) Heston assets with correlated price drivers.

    Each asset runs its own exact CIR variance path (independent variance
    drivers across assets) and Andersen's scheme given it, exactly as the
    single-asset :class:`HestonPath`.  The asset Brownians carry ``corr``:
    with ``W_Si = rho_i B_i + sqrt(1 - rho_i^2) Z_i`` (``B_i`` the
    variance driver), the idiosyncratic block is recoloured by

        Q_ij = corr_ij / sqrt((1 - rho_i^2)(1 - rho_j^2)),   Q_ii = 1,

    which must be positive definite (strong leverage caps the diffusive
    cross-correlation).  ``var_corr=lambda`` in [0, 1) adds a common
    variance factor: each asset's variance normal is ``sqrt(lambda) g +
    sqrt(1 - lambda) eps_a`` with one shared ``g`` per (path, step), every
    per-asset marginal law unchanged.  Use the ``CorrelatedHeston``
    factory for the views.
    """

    @property
    def _param_slots(self):
        # rho is excluded, unlike HestonPath: chol(Q) depends on it and is
        # fixed at construction.
        return tuple(f"{p}[{i}]" for p in ("s0", "mu", "v0") for i in range(self.d))

    def __init__(
        self, s0, mu, v0, kappa, theta, sigma, rho, corr, T=1.0, steps=252, var_corr=0.0,
    ):
        from probabilit_tpu_torch.ops.copulas import corr_cholesky

        var_corr = float(var_corr)
        if not 0.0 <= var_corr < 1.0:
            raise ValueError(
                f"var_corr must be in [0, 1), got {var_corr} (1 would "
                "make every asset's variance innovations identical)."
            )
        d, corr, p = self._asset_params(
            "CorrelatedHeston", s0, corr, mu=mu, v0=v0, kappa=kappa, theta=theta,
            sigma=sigma, rho=rho,
        )
        if not (p["s0"] > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (np.abs(p["rho"]) < 1).all():
            raise ValueError("Every rho must be in (-1, 1).")
        for a in range(d):
            _validate_cir(
                p["v0"][a], p["kappa"][a], p["theta"][a], p["sigma"][a], what=f"v0[{a}]"
            )
        # corr must be a correlation matrix, and so must the implied
        # idiosyncratic Q.
        corr_cholesky(corr)
        scale = np.sqrt(1.0 - p["rho"] ** 2)
        Q = corr / np.outer(scale, scale)
        np.fill_diagonal(Q, 1.0)
        try:
            chol_q = np.linalg.cholesky(Q)
        except np.linalg.LinAlgError:
            raise ValueError(
                "corr is infeasible with these leverage rhos: with "
                "independent per-asset variance drivers the idiosyncratic "
                "drivers must carry Q_ij = corr_ij / "
                "sqrt((1-rho_i^2)(1-rho_j^2)), which must be positive "
                "definite (in particular |corr_ij| < "
                "sqrt((1-rho_i^2)(1-rho_j^2))).  Weaken corr or the rhos."
            ) from None
        self.s0 = p["s0"]
        self.mu = p["mu"]
        self.v0 = p["v0"]
        self.kappa = p["kappa"]
        self.theta = p["theta"]
        self.sigma = p["sigma"]
        self.rho = p["rho"]
        self.corr = corr
        self._chol_q = chol_q
        self.d = d
        self.var_corr = var_corr
        super().__init__(steps, T)

    def __repr__(self):
        extra = f", var_corr={self.var_corr:g}" if self.var_corr else ""
        return f"CorrelatedHestonPaths(d={self.d}, T={self.T:g}, steps={self.steps}{extra})"

    def _static_signature(self):
        return (
            "CorrelatedHestonPaths", self.s0.tobytes(), self.mu.tobytes(), self.v0.tobytes(),
            self.kappa.tobytes(), self.theta.tobytes(), self.sigma.tobytes(),
            self.rho.tobytes(), self.corr.tobytes(), self.T, self.steps, self.var_corr,
        )

    @property
    def _q_width(self):
        # Per (asset, step): the asset normal, the variance normal and its
        # chi-square; one more steps-wide block for the common variance
        # factor when var_corr > 0.
        return (3 * self.d + (1 if self.var_corr else 0)) * self.steps

    def _constants(self):
        dt = self.T / self.steps
        e = np.exp(-self.kappa * dt)
        c = self.sigma**2 * (1.0 - e) / (4.0 * self.kappa)
        df = 4.0 * self.kappa * self.theta / (self.sigma**2)
        return e, c, df

    def _mix_common_var(self, zv, g):
        """``z_a := sqrt(lam) g + sqrt(1 - lam) eps_a``: every z_a stays
        standard normal, with correlation lam across assets."""
        lam = self.var_corr
        return (lam**0.5) * g[:, :, None] + ((1.0 - lam) ** 0.5) * zv

    def _increments(self, gen, n, dtype):
        _, _, df = self._constants()
        zs = normal(gen, (n, self.steps, self.d), dtype)
        zv, y = zip(*(
            _cir_drivers_key(gen, n, self.steps, float(df[a]), dtype) for a in range(self.d)
        ))
        zv = torch.stack(zv, dim=2)
        if self.var_corr:
            zv = self._mix_common_var(zv, normal(gen, (n, self.steps), dtype))
        return torch.stack([zs, zv, torch.stack(y, dim=2)], dim=2)  # (n, steps, 3, d)

    def _increments_from_slab(self, slab, dtype):
        # Slab layout [d bridged asset-normal blocks | d variance-normal
        # blocks | d chi-square blocks | the common factor's block],
        # asset-major in each part, as HestonPath's per asset.
        _, _, df = self._constants()
        s, d = self.steps, self.d
        zs = _stack_bridged(slab, 0, d, s, dtype)
        zv, y = zip(*(
            _cir_drivers_slab(
                slab[:, (d + a) * s : (d + a + 1) * s],
                slab[:, (2 * d + a) * s : (2 * d + a + 1) * s],
                float(df[a]),
                dtype,
            )
            for a in range(d)
        ))
        zv = torch.stack(zv, dim=2)
        if self.var_corr:
            # Plain per-step dimensions, like the variance drivers.
            g = _special.ndtri_fast(slab[:, 3 * d * s : (3 * d + 1) * s].to(dtype))
            zv = self._mix_common_var(zv, g)
        return torch.stack([zs, zv, torch.stack(y, dim=2)], dim=2)

    def _state_paths_from_increments(self, inc):
        """(asset_0..asset_{d-1}, var_0..var_{d-1}): the full Markov state;
        an LSMC payoff takes the first ``d`` (``_payoff_arity``)."""
        paths, v = self._paths_and_variances(inc)
        return tuple(paths[:, i, :] for i in range(self.d)) + tuple(
            v[:, :, i] for i in range(self.d)
        )

    def _paths_and_variances(self, inc):
        dtype, device = inc.dtype, inc.device
        dt = self.T / self.steps
        e, c, _ = self._constants()

        def vec(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        v = _cir_scan(self.v0, e, c, inc[:, :, 1, :], inc[:, :, 2, :])
        # The idiosyncratic asset normals recoloured so the asset
        # Brownians carry corr (the unrolled chain of _recolor_assets).
        zsc = _recolor_assets(inc[:, :, 0, :], self._chol_q)
        dlog = _andersen_dlog(
            vec(self.mu), vec(self.kappa), vec(self.theta), vec(self.sigma), vec(self.rho),
            self.v0, v, zsc, dt,
        )
        paths = (vec(self.s0) * torch.exp(time_cumsum(dlog))).transpose(1, 2).contiguous()
        return paths, v

    def _path_from_increments(self, inc):
        return self._paths_and_variances(inc)[0]


def CorrelatedHeston(
    s0, mu, v0, kappa, theta, sigma, rho, corr, T=1.0, steps=252, var_corr=0.0,
):
    """d correlated Heston assets from one exact joint draw (see
    :class:`CorrelatedHestonPaths`); one :class:`AssetPath` view per asset:

    >>> a, b = CorrelatedHeston([100, 50], [0.0, 0.0], v0=0.04, kappa=2.0,
    ...                         theta=0.04, sigma=0.3, rho=[-0.5, -0.3],
    ...                         corr=[[1, 0.6], [0.6, 1]], steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    return CorrelatedHestonPaths(
        s0, mu, v0, kappa, theta, sigma, rho, corr, T=T, steps=steps, var_corr=var_corr
    ).views()
