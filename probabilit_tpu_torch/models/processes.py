"""Stochastic-process nodes: Brownian, GBM, OU, Poisson, Merton paths,
and the joint multi-asset paths.

Port of ``probabilit_tpu/models/processes.py``.  A path node samples an
``(n, steps)`` matrix of process paths from exact grid-increment laws: a
Gaussian cumulative sum (Brownian, GBM), an affine scan
(Ornstein-Uhlenbeck), Poisson increments (the counting process) and
compound-Poisson-normal jumps (Merton), so every time slice has the
process's exact law.  Functionals (terminal value, running max and min,
time average, a time slice) project a path back to the scalar nodes the
rest of the graph works with.

Randomness has two modes (``engine/compile.EmitContext.drawn``):

* **the engine drew the uniforms** (``sample(method=None)``, streamed
  ``method=None`` blocks): the node reads its own column, one uniform a
  row, and draws its increments from a ``torch.Generator`` keyed by that
  column (``ops/multivariate._key_from_q``), one generator per node and
  call.  The JAX package folds the same bits into a jax key, which cannot
  be reproduced, so these draws differ from the JAX package's by design
  and are held to the exact laws instead;
* **an explicit quantile matrix** (a ``method=`` sequence,
  ``sample_from_quantiles``): the node reads its slab of ``_q_width``
  columns (``EmitContext.slab``) and builds its Gaussian drivers through
  the Brownian bridge (``ops/bridge.py``).  The slab fixes the result, so
  this mode matches the JAX package on the same matrix, and a streamed
  ``method=`` run equals the one-shot run bit for bit.

The JAX package pins the sample axis of a key-drawn increment matrix to
the mesh (``parallel/mesh.sample_sharding``); the port is single-device
until ROADMAP A12, so there is nothing to pin.

>>> gbm = GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2, T=1.0)
>>> gbm.terminal()
PathFunctional(GBMPath(s0=100, mu=0.05, sigma=0.2, T=1, steps=252), 'terminal')
"""

from __future__ import annotations

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models.distributions import AbstractDistribution
from probabilit_tpu_torch.models.graph import Transform
from probabilit_tpu_torch.ops import bridge as _bridge
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import special as _special
from probabilit_tpu_torch.ops.qmc import clamp_open_unit

__all__ = [
    "BrownianMotion",
    "GeometricBrownianMotion",
    "OrnsteinUhlenbeck",
    "PoissonProcess",
    "MertonJumpDiffusion",
    "CorrelatedGBM",
    "CorrelatedMerton",
    "PathDistribution",
    "PathFunctional",
]


def normal(gen, shape, dtype):
    """Standard normals from a key-mode generator, on its device."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def uniform(gen, shape, dtype):
    """Uniforms in the open unit interval from a key-mode generator."""
    return clamp_open_unit(torch.rand(shape, generator=gen, dtype=dtype, device=gen.device))


def time_major(x):
    """A time-major copy of ``x`` (dim 1 first): each step's slice is
    contiguous, for the loops over the steps and the time-axis scans."""
    return x.movedim(1, 0).contiguous()


def sample_major(x):
    """The inverse of ``time_major``: a path value is sample-major (each
    path contiguous), so a functional's reduction over the steps runs
    within a row, in the same order whatever the batch."""
    return x.movedim(0, 1).contiguous()


def time_cumsum(x):
    """Cumulative sum along the time axis (dim 1).  Each row is summed in
    the same order whatever the batch: the scan runs along dim 0 of a
    time-major copy.  ``torch.cumsum`` along the last axis is not
    batch-independent on the card (on one H100 the rows of a 2^18-row call
    differed from those of its 2^16-row blocks), and a streamed
    ``method=`` run must equal its one-shot run bit for bit."""
    return sample_major(torch.cumsum(time_major(x), dim=0))


def poisson_counts(u, rate):
    """Poisson(rate) counts of uniforms ``u`` (a static rate: the CDF
    table branch of ``ppf.poisson``), in ``u``'s dtype."""
    return _ppf.call("poisson", u, mu=rate).to(u.dtype)


class PathFunctionalMixin:
    """Functional shortcuts shared by path leaves and asset views.

    Memoised per (op, index): repeated ``path.terminal()`` calls give the
    same node, so ``path.terminal().samples_`` after sampling any
    expression built from it is what a user expects.  Needs a ``steps``
    attribute and an ``(n, steps)``-valued emission.
    """

    _is_path = True

    def _functional(self, op, index=None):
        cache = self.__dict__.setdefault("_functional_cache", {})
        key = (op, index)
        if key not in cache:
            cache[key] = PathFunctional(self, op, index=index)
        return cache[key]

    def terminal(self):
        """Value at time T."""
        return self._functional("terminal")

    def maximum(self):
        """Running maximum over the grid (discrete-time supremum)."""
        return self._functional("max")

    def minimum(self):
        """Running minimum over the grid."""
        return self._functional("min")

    def average(self):
        """Time average over the grid (an Asian payoff's ingredient)."""
        return self._functional("mean")

    def at(self, step):
        """Value at grid point ``step`` (time ``(step + 1) * T / steps``)."""
        step = int(step)
        if not 0 <= step < self.steps:
            raise ValueError(f"step must be in [0, {self.steps}), got {step}.")
        return self._functional("at", index=step)


class PathDistribution(PathFunctionalMixin, AbstractDistribution):
    """Base path node: ``(n, steps)`` sample paths on a uniform grid.

    The grid is ``dt, 2*dt, ..., T`` with ``dt = T / steps`` (the start
    point is the deterministic ``x0``/``s0`` and is not stored).
    """

    is_leaf = True
    _vector_valued = True
    # Differentiable scalar parameters (pathwise sensitivities swap these
    # attributes for tensors that carry gradients); empty means the family
    # has no valid pathwise derivative.
    _param_slots = ()

    def __init__(self, steps, T):
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}.")
        T = float(T)
        if not T > 0:
            raise ValueError(f"T must be positive, got {T}.")
        self.steps = steps
        self.T = T
        super().__init__()

    def get_parents(self):
        return iter(())

    def _rewire(self, update):
        # Called on the copy in Node.copy(): the shallow copy shares the
        # memo, whose functionals are parented to the original path.
        self.__dict__.pop("_functional_cache", None)

    def _mv_dim(self):
        return self.steps

    @property
    def _q_width(self):
        """Quantile columns read on an explicit matrix (one per driver):
        one per step here; families with more drivers widen it."""
        return self.steps

    def _increments(self, gen, n, dtype):
        raise NotImplementedError

    def _increments_from_slab(self, slab, dtype):
        raise NotImplementedError

    def _state_paths_from_increments(self, inc):
        """The full per-date state: a tuple of ``(n, steps)`` tensors.

        Entry 0 is the observable path (what ``_emit`` returns);
        multi-factor families add their hidden factors (Heston: the
        variance) for state-aware consumers such as an LSMC regression.
        """
        return (self._path_from_increments(inc),)

    def _regrid(self, steps):
        """Same family and parameters on a ``steps``-point grid (the
        exact-law families and the SDE node; multilevel estimation couples
        grids through it)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support grid refinement; "
            "multilevel estimation needs an SDE node or an exact-law "
            "Gaussian-driven family (Brownian/GBM/OU)."
        )

    def _increments_from_normals(self, z, dtype):
        """Per-step increments from iid N(0, 1) drivers ``z`` (n, steps):
        the multilevel coupling hook of the families driven by exactly one
        standard normal a step."""
        raise NotImplementedError(
            f"{type(self).__name__} is not driven by one standard normal "
            "per step; no exact-law grid coupling exists."
        )

    def _bridge_z(self, slab, dtype):
        """Uniform slab -> iid N(0, 1) increments in Brownian-bridge order:
        slab dimension 0 sets the terminal point, later ones refine."""
        return _bridge.normal_increments(slab, dtype)

    def _emit(self, ctx):
        dtype = config.float_dtype()
        if ctx.drawn:
            from probabilit_tpu_torch.ops import multivariate as mv

            inc = self._increments(mv._key_from_q(ctx.column(self)), ctx.n, dtype)
        else:
            inc = self._increments_from_slab(ctx.slab(self), dtype)
        return self._path_from_increments(inc)


class _GaussianPath(PathDistribution):
    """A family driven by one standard normal a step: key mode draws the
    normals, an explicit matrix builds them through the bridge."""

    def _increments(self, gen, n, dtype):
        return self._increments_from_normals(normal(gen, (n, self.steps), dtype), dtype)

    def _increments_from_slab(self, slab, dtype):
        return self._increments_from_normals(self._bridge_z(slab, dtype), dtype)


class BrownianPath(_GaussianPath):
    """Arithmetic Brownian motion ``x0 + drift*t + diffusion*W_t``.

    Every grid slice is exact: the increments are iid
    ``N(drift*dt, diffusion^2*dt)`` and the path is their cumulative sum.
    """

    _param_slots = ("x0", "drift", "diffusion")

    def __init__(self, x0=0.0, drift=0.0, diffusion=1.0, T=1.0, steps=252):
        diffusion = float(diffusion)
        if not diffusion > 0:
            raise ValueError(f"diffusion must be positive, got {diffusion}.")
        self.x0 = float(x0)
        self.drift = float(drift)
        self.diffusion = diffusion
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"BrownianPath(x0={self.x0:g}, drift={self.drift:g}, "
            f"diffusion={self.diffusion:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return ("BrownianPath", self.x0, self.drift, self.diffusion, self.T, self.steps)

    def _increments_from_normals(self, z, dtype):
        dt = self.T / self.steps
        return self.drift * dt + self.diffusion * (dt**0.5) * z

    def _regrid(self, steps):
        return BrownianPath(
            x0=self.x0, drift=self.drift, diffusion=self.diffusion, T=self.T, steps=steps
        )

    def _path_from_increments(self, inc):
        return self.x0 + time_cumsum(inc)


class GBMPath(_GaussianPath):
    """Geometric Brownian motion ``s0 * exp((mu - sigma^2/2) t + sigma W_t)``.

    Exact in law at every grid slice, so ``terminal()`` is lognormal with
    ``E[S_T] = s0 * exp(mu T)``.
    """

    _param_slots = ("s0", "mu", "sigma")

    def __init__(self, s0=1.0, mu=0.0, sigma=0.2, T=1.0, steps=252):
        s0 = float(s0)
        sigma = float(sigma)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        self.s0 = s0
        self.mu = float(mu)
        self.sigma = sigma
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"GBMPath(s0={self.s0:g}, mu={self.mu:g}, sigma={self.sigma:g}, "
            f"T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return ("GBMPath", self.s0, self.mu, self.sigma, self.T, self.steps)

    def _increments_from_normals(self, z, dtype):
        dt = self.T / self.steps
        return (self.mu - 0.5 * self.sigma**2) * dt + self.sigma * (dt**0.5) * z

    def _regrid(self, steps):
        return GBMPath(s0=self.s0, mu=self.mu, sigma=self.sigma, T=self.T, steps=steps)

    def _path_from_increments(self, inc):
        return self.s0 * torch.exp(time_cumsum(inc))


def _affine_scan(a, inc):
    """``(a^(k+1), sum_{j<=k} a^(k-j) inc_j)`` along dim 1: the prefix
    compositions of the affine maps ``x -> a x + inc_k``.

    A log-depth doubling scan (Hillis-Steele): after the round at distance
    ``off`` each entry sums a window of ``2 off`` innovations, the older
    half weighted by ``a^off``.  Only powers of ``a <= 1`` appear, so
    nothing overflows at any ``theta * T`` (the JAX package's
    ``associative_scan`` composes the same maps in a tree).
    """
    steps = inc.shape[1]
    acc, w, off = inc, a, 1
    while off < steps:
        acc = torch.cat([acc[:, :off], acc[:, off:] + w * acc[:, :-off]], dim=1)
        w = w * w
        off *= 2
    powers = torch.cumprod(a.expand(steps), dim=0)
    return powers, acc


class OUPath(_GaussianPath):
    """Ornstein-Uhlenbeck ``dX = theta (mu - X) dt + sigma dW``, exact.

    The exact transition is ``X_k = a X_{k-1} + b + c Z_k`` with ``a =
    exp(-theta dt)``, ``b = mu (1 - a)``, ``c = sigma sqrt((1 - a^2) / (2
    theta))``; the path is one scan of these affine maps along the time
    axis (``_affine_scan``).  Every slice is exactly
    ``N(mu + (x0 - mu) a^k, sigma^2 (1 - a^(2k)) / (2 theta))``.
    """

    _param_slots = ("x0", "theta", "mu", "sigma")

    def __init__(self, x0=0.0, theta=1.0, mu=0.0, sigma=1.0, T=1.0, steps=252):
        theta = float(theta)
        sigma = float(sigma)
        if not theta > 0:
            raise ValueError(f"theta must be positive, got {theta}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        self.x0 = float(x0)
        self.theta = theta
        self.mu = float(mu)
        self.sigma = sigma
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"OUPath(x0={self.x0:g}, theta={self.theta:g}, mu={self.mu:g}, "
            f"sigma={self.sigma:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return ("OUPath", self.x0, self.theta, self.mu, self.sigma, self.T, self.steps)

    def _decay(self, dtype):
        # Tensors, not math: a parameter may be a tensor that carries a
        # gradient (pathwise sensitivities).
        theta = torch.as_tensor(self.theta, dtype=dtype)
        return torch.exp(-theta * (self.T / self.steps)), theta

    def _increments_from_normals(self, z, dtype):
        a, theta = self._decay(dtype)
        b = self.mu * (1.0 - a)
        c = self.sigma * torch.sqrt((1.0 - a * a) / (2.0 * theta))
        return b + c * z

    def _regrid(self, steps):
        return OUPath(
            x0=self.x0, theta=self.theta, mu=self.mu, sigma=self.sigma, T=self.T, steps=steps
        )

    def _path_from_increments(self, inc):
        a, _ = self._decay(inc.dtype)
        powers, acc = _affine_scan(a.to(inc.device), inc)
        return powers * self.x0 + acc


class PoissonProcessPath(PathDistribution):
    """Homogeneous Poisson counting process ``N_t``, exact increments.

    Grid increments are iid ``Poisson(rate * dt)`` (the poisson inverse
    CDF of one uniform a step, no bridge: counts are not Gaussian); the
    path is their cumulative sum, so ``at(k) ~ Poisson(rate (k+1) dt)``.
    """

    def __init__(self, rate=1.0, T=1.0, steps=252):
        rate = float(rate)
        if not rate > 0:
            raise ValueError(f"rate must be positive, got {rate}.")
        self.rate = rate
        super().__init__(steps, T)

    def __repr__(self):
        return f"PoissonProcessPath(rate={self.rate:g}, T={self.T:g}, steps={self.steps})"

    def _static_signature(self):
        return ("PoissonProcessPath", self.rate, self.T, self.steps)

    def _increments(self, gen, n, dtype):
        return poisson_counts(uniform(gen, (n, self.steps), dtype), self.rate * self.T / self.steps)

    def _increments_from_slab(self, slab, dtype):
        return poisson_counts(slab.to(dtype), self.rate * self.T / self.steps)

    def _path_from_increments(self, inc):
        return time_cumsum(inc)


class MertonJumpPath(PathDistribution):
    """Merton jump-diffusion asset path, exact per grid step.

    ``log S`` increments per step of length ``dt``:

        (mu - sigma^2/2) dt + sigma sqrt(dt) Z
        + jump_mean * K + jump_std * sqrt(K) * Z'

    with ``K ~ Poisson(jump_rate * dt)``: given the count, the summed
    normal jumps are exactly ``N(K jump_mean, K jump_std^2)``.  ``E[S_T] =
    s0 exp(mu T + jump_rate T (exp(jump_mean + jump_std^2/2) - 1))``
    (``mu`` is the continuous part's drift, uncompensated).
    """

    # jump_rate enters through the discrete count, whose pathwise
    # derivative is zero almost everywhere.
    _param_slots = ("s0", "mu", "sigma", "jump_mean", "jump_std")

    def __init__(
        self, s0=1.0, mu=0.0, sigma=0.2, jump_rate=1.0, jump_mean=0.0, jump_std=0.1,
        T=1.0, steps=252,
    ):
        s0, sigma = float(s0), float(sigma)
        jump_rate, jump_std = float(jump_rate), float(jump_std)
        if not s0 > 0:
            raise ValueError(f"s0 must be positive, got {s0}.")
        if not sigma > 0:
            raise ValueError(f"sigma must be positive, got {sigma}.")
        if not jump_rate > 0:
            raise ValueError(f"jump_rate must be positive, got {jump_rate}.")
        if not jump_std >= 0:
            raise ValueError(f"jump_std must be >= 0, got {jump_std}.")
        self.s0 = s0
        self.mu = float(mu)
        self.sigma = sigma
        self.jump_rate = jump_rate
        self.jump_mean = float(jump_mean)
        self.jump_std = jump_std
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"MertonJumpPath(s0={self.s0:g}, mu={self.mu:g}, "
            f"sigma={self.sigma:g}, jump_rate={self.jump_rate:g}, "
            f"jump_mean={self.jump_mean:g}, jump_std={self.jump_std:g}, "
            f"T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "MertonJumpPath", self.s0, self.mu, self.sigma, self.jump_rate,
            self.jump_mean, self.jump_std, self.T, self.steps,
        )

    @property
    def _q_width(self):
        # Three drivers a step: diffusion normal, jump-count uniform,
        # summed-jump normal.
        return 3 * self.steps

    def _increments(self, gen, n, dtype):
        dt = self.T / self.steps
        shape = (n, self.steps)
        z = normal(gen, shape, dtype)
        k_jumps = poisson_counts(uniform(gen, shape, dtype), self.jump_rate * dt)
        zj = normal(gen, shape, dtype)
        return self._combine(z, k_jumps, zj, dt)

    def _increments_from_slab(self, slab, dtype):
        # Slab layout [diffusion | jump counts | jump sizes]: the diffusion
        # normals take the leading dimensions and the bridge order; the
        # counts and the conditional jump sums read theirs directly.
        dt = self.T / self.steps
        s = self.steps
        z = _bridge.normal_increments(slab[:, :s], dtype)
        k_jumps = poisson_counts(slab[:, s : 2 * s].to(dtype), self.jump_rate * dt)
        zj = _special.ndtri_fast(slab[:, 2 * s :].to(dtype))
        return self._combine(z, k_jumps, zj, dt)

    def _combine(self, z, k_jumps, zj, dt):
        diffusion = (self.mu - 0.5 * self.sigma**2) * dt + self.sigma * (dt**0.5) * z
        jumps = self.jump_mean * k_jumps + self.jump_std * torch.sqrt(k_jumps) * zj
        return diffusion + jumps

    def _path_from_increments(self, inc):
        return self.s0 * torch.exp(time_cumsum(inc))


class PathFunctional(Transform):
    """Scalar projection of a path node: terminal/max/min/mean/at."""

    _OPS = ("terminal", "max", "min", "mean", "at")

    def __init__(self, path, op, index=None):
        if not getattr(path, "_is_path", False):
            raise TypeError(
                "PathFunctional needs a SCALAR path node ((n, steps)-"
                f"valued; a PathDistribution or AssetPath view), got {path!r}."
            )
        if op not in self._OPS:
            raise ValueError(f"op must be one of {self._OPS}, got {op!r}.")
        if (op == "at") != (index is not None):
            raise ValueError("index is required for op='at' and only then.")
        self.path = path
        self.op = op
        self.index = index
        super().__init__()

    def __repr__(self):
        extra = f", {self.index}" if self.op == "at" else ""
        return f"{type(self).__name__}({self.path!r}, '{self.op}'{extra})"

    def get_parents(self):
        yield self.path

    def _rewire(self, update):
        self.path = update(self.path)

    def _static_signature(self):
        return ("PathFunctional", self.op, self.index)

    def _emit(self, ctx):
        paths = ctx.value(self.path)
        if self.op == "terminal":
            return paths[:, -1]
        if self.op == "max":
            return torch.amax(paths, dim=1)
        if self.op == "min":
            return torch.amin(paths, dim=1)
        if self.op == "mean":
            return torch.mean(paths, dim=1)
        return paths[:, self.index]


def BrownianMotion(x0=0.0, drift=0.0, diffusion=1.0, T=1.0, steps=252):
    """Arithmetic Brownian path node; see :class:`BrownianPath`.

    >>> w = BrownianMotion(T=2.0, steps=8)
    >>> w.at(7)
    PathFunctional(BrownianPath(x0=0, drift=0, diffusion=1, T=2, steps=8), 'at', 7)
    """
    return BrownianPath(x0=x0, drift=drift, diffusion=diffusion, T=T, steps=steps)


def GeometricBrownianMotion(s0=1.0, mu=0.0, sigma=0.2, T=1.0, steps=252):
    """Geometric Brownian path node; see :class:`GBMPath`.

    >>> GeometricBrownianMotion(s0=100, mu=0.05, sigma=0.2).terminal()
    PathFunctional(GBMPath(s0=100, mu=0.05, sigma=0.2, T=1, steps=252), 'terminal')
    """
    return GBMPath(s0=s0, mu=mu, sigma=sigma, T=T, steps=steps)


def OrnsteinUhlenbeck(x0=0.0, theta=1.0, mu=0.0, sigma=1.0, T=1.0, steps=252):
    """Mean-reverting OU path node (rates, spreads); see :class:`OUPath`.

    >>> OrnsteinUhlenbeck(theta=2.0, mu=0.05, sigma=0.1, T=1.0, steps=4)
    OUPath(x0=0, theta=2, mu=0.05, sigma=0.1, T=1, steps=4)
    """
    return OUPath(x0=x0, theta=theta, mu=mu, sigma=sigma, T=T, steps=steps)


def PoissonProcess(rate=1.0, T=1.0, steps=252):
    """Poisson counting-process path node; see :class:`PoissonProcessPath`.

    >>> PoissonProcess(rate=3.0, T=2.0, steps=8).terminal()
    PathFunctional(PoissonProcessPath(rate=3, T=2, steps=8), 'terminal')
    """
    return PoissonProcessPath(rate=rate, T=T, steps=steps)


def MertonJumpDiffusion(
    s0=1.0, mu=0.0, sigma=0.2, jump_rate=1.0, jump_mean=0.0, jump_std=0.1, T=1.0, steps=252,
):
    """Merton jump-diffusion asset path node; see :class:`MertonJumpPath`.

    >>> MertonJumpDiffusion(s0=100, sigma=0.2, jump_rate=0.5, steps=4)
    MertonJumpPath(s0=100, mu=0, sigma=0.2, jump_rate=0.5, jump_mean=0, jump_std=0.1, T=1, steps=4)
    """
    return MertonJumpPath(
        s0=s0, mu=mu, sigma=sigma, jump_rate=jump_rate, jump_mean=jump_mean,
        jump_std=jump_std, T=T, steps=steps,
    )


def _recolor_assets(z, chol):
    """(n, steps, d) iid drivers -> correlated drivers along the asset axis.

    An unrolled lower-triangular multiply-add chain, in the JAX package's
    order (zero entries skipped), rather than a ``(d, d)`` product: d is
    tiny, and the chain's sum order is what the parity tests hold.
    """
    cols = []
    for i in range(chol.shape[0]):
        acc = z[:, :, 0] * float(chol[i, 0])
        for j in range(1, i + 1):
            if chol[i, j] != 0.0:
                acc = acc + z[:, :, j] * float(chol[i, j])
        cols.append(acc)
    return torch.stack(cols, dim=2)


def _stack_bridged(slab, first, d, steps, dtype):
    """(n, steps, d) bridge-ordered normals from ``d`` consecutive
    steps-wide slab blocks starting at block ``first`` (asset-major)."""
    return torch.stack(
        [
            _bridge.normal_increments(slab[:, (first + a) * steps : (first + a + 1) * steps], dtype)
            for a in range(d)
        ],
        dim=2,
    )


class JointAssetPaths(PathDistribution):
    """Base of the joint multi-asset path nodes: ``(n, d, steps)`` values.

    A joint node samples all ``d`` assets from one coupled law; users reach
    it through the per-asset :class:`AssetPath` views the factories
    return.  Subclasses validate their parameters through
    :meth:`_asset_params` (first axis the asset), produce joint
    increments whose leading two axes are sample and time, and by default
    build log-price paths ``s0 * exp(cumsum)``.
    """

    # Not a scalar path surface: the emission is (n, d, steps), so
    # PathFunctional refuses it (a functional here would reduce over the
    # wrong axis).  Use the per-asset views.
    _is_path = False

    @staticmethod
    def _asset_params(name, s0, corr, **params):
        """Validated ``(d, corr, {name: (d,) float64 vector})``: ``s0``
        fixes the asset count; every other parameter matches its length or
        is a true scalar (a list of length one is a length mismatch)."""
        s0 = np.asarray(s0, np.float64).ravel()
        d = s0.shape[0]
        if d < 2:
            raise ValueError(f"{name} needs >= 2 assets, got {d}.")
        out = {"s0": s0}
        for k, v in params.items():
            a = np.asarray(v, np.float64)
            out[k] = np.full(d, float(a)) if a.ndim == 0 else a.ravel()
        if any(v.shape != (d,) for v in out.values()):
            raise ValueError(
                "/".join(out) + " must have equal lengths; got "
                + "/".join(str(v.shape[0]) for v in out.values()) + "."
            )
        corr = np.asarray(corr, np.float64)
        if corr.shape != (d, d):
            raise ValueError(f"corr must be ({d}, {d}), got {corr.shape}.")
        return d, corr, out

    def views(self):
        """One :class:`AssetPath` per asset, in parameter order."""
        return tuple(AssetPath(self, i) for i in range(self.d))

    @property
    def _payoff_arity(self):
        """How many leading state paths an LSMC payoff takes: d (one
        per-asset slice an argument); scalar nodes take 1."""
        return self.d

    def _state_paths_from_increments(self, inc):
        """Per-asset paths as the LSMC state tuple (d tensors (n, steps))."""
        paths = self._path_from_increments(inc)
        return tuple(paths[:, i, :] for i in range(self.d))

    def _path_from_increments(self, inc):
        """(n, d, steps) price paths from (n, steps, d) log-increments,
        asset-major so each view is a contiguous slice."""
        logpath = time_cumsum(inc)
        s0 = torch.as_tensor(self.s0, dtype=inc.dtype, device=inc.device)
        return (s0 * torch.exp(logpath)).transpose(1, 2).contiguous()

    def _functional(self, op, index=None):
        raise TypeError(
            "Apply functionals to a per-asset view (the factory's "
            "returned nodes), not the joint node."
        )


class CorrelatedGBMPaths(JointAssetPaths):
    """Joint (n, d, steps) geometric-Brownian paths with correlated drivers.

    One (n, steps, d) standard-normal draw is recoloured by the Cholesky
    factor of ``corr`` along the asset axis, then each asset runs the
    exact GBM cumsum: log-terminal correlations equal ``corr`` exactly at
    every horizon.  Use the ``CorrelatedGBM`` factory for the views.
    """

    @property
    def _param_slots(self):
        # corr is excluded: the Cholesky factor is fixed at construction.
        return tuple(f"{p}[{i}]" for p in ("s0", "mu", "sigma") for i in range(self.d))

    def __init__(self, s0, mu, sigma, corr, T=1.0, steps=252):
        from probabilit_tpu_torch.ops.copulas import corr_cholesky

        d, corr, p = self._asset_params("CorrelatedGBM", s0, corr, mu=mu, sigma=sigma)
        s0, mu, sigma = p["s0"], p["mu"], p["sigma"]
        if not (s0 > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (sigma > 0).all():
            raise ValueError("Every sigma must be positive.")
        chol, _ = corr_cholesky(corr)
        self.s0 = s0
        self.mu = mu
        self.sigma = sigma
        self.corr = corr
        self._chol = chol
        self.d = d
        super().__init__(steps, T)

    def __repr__(self):
        return f"CorrelatedGBMPaths(d={self.d}, T={self.T:g}, steps={self.steps})"

    def _static_signature(self):
        return (
            "CorrelatedGBMPaths", self.s0.tobytes(), self.mu.tobytes(),
            self.sigma.tobytes(), self.corr.tobytes(), self.T, self.steps,
        )

    @property
    def _q_width(self):
        # One Gaussian driver per (asset, step), asset-major.
        return self.d * self.steps

    def _increments(self, gen, n, dtype):
        z = normal(gen, (n, self.steps, self.d), dtype)
        return self._recolor(z, self.T / self.steps, dtype)

    def _increments_from_slab(self, slab, dtype):
        # Asset a owns columns [a*steps, (a+1)*steps), each block in bridge
        # order, so dimensions 0, steps, 2*steps, ... set the terminals.
        z = _stack_bridged(slab, 0, self.d, self.steps, dtype)
        return self._recolor(z, self.T / self.steps, dtype)

    def _recolor(self, z, dt, dtype):
        zc = _recolor_assets(z, self._chol)
        drift = torch.as_tensor((self.mu - 0.5 * self.sigma**2) * dt, dtype=dtype, device=z.device)
        vol = torch.as_tensor(self.sigma * dt**0.5, dtype=dtype, device=z.device)
        return drift + vol * zc  # (n, steps, d) log-increments


class AssetPath(PathFunctionalMixin, Transform):
    """One asset's (n, steps) view of a joint correlated-paths node."""

    _vector_valued = True

    def __init__(self, joint, asset):
        if not isinstance(joint, JointAssetPaths):
            raise TypeError(
                "AssetPath views a joint multi-asset paths node "
                f"(CorrelatedGBM/CorrelatedMerton/CorrelatedHeston), got {joint!r}."
            )
        asset = int(asset)
        if not 0 <= asset < joint.d:
            raise ValueError(f"asset must be in [0, {joint.d}), got {asset}.")
        self.joint = joint
        self.asset = asset
        self.steps = joint.steps
        self.T = joint.T
        super().__init__()

    def __repr__(self):
        return f"AssetPath({self.joint!r}, asset={self.asset})"

    def get_parents(self):
        yield self.joint

    def _rewire(self, update):
        self.joint = update(self.joint)
        self.__dict__.pop("_functional_cache", None)

    def _static_signature(self):
        return ("AssetPath", self.asset)

    def _emit(self, ctx):
        return ctx.value(self.joint)[:, self.asset, :]


def CorrelatedGBM(s0, mu, sigma, corr, T=1.0, steps=252):
    """d correlated GBM asset paths from one exact joint draw; one
    :class:`AssetPath` view per asset:

    >>> a, b = CorrelatedGBM([100, 50], [0.03, 0.02], [0.2, 0.3],
    ...                      [[1, 0.6], [0.6, 1]], steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    return CorrelatedGBMPaths(s0, mu, sigma, corr, T=T, steps=steps).views()


class CorrelatedMertonPaths(JointAssetPaths):
    """Joint (n, d, steps) Merton jump-diffusion paths, exact per step.

    Three independent exact layers build each step's log-increment vector:
    correlated diffusion (one (n, steps, d) normal draw recoloured by the
    Cholesky factor of ``corr``), idiosyncratic jumps (per asset ``K ~
    Poisson(rate_i dt)`` and the summed normal jumps ``N(K jm_i, K
    js_i^2)``; ``rate_i = 0`` switches them off) and common jumps (one
    shared count ``K_c ~ Poisson(common_rate dt)`` with summed size ``X ~
    N(K_c cm, K_c cs^2)`` hitting asset i as ``loadings_i * X``).  The
    log-terminal moments are closed form:

        E ln(S_Ti/s0_i) = [mu_i - sigma_i^2/2 + rate_i jm_i
                           + load_i cm common_rate] T
        Var ln S_Ti     = [sigma_i^2 + rate_i (jm_i^2 + js_i^2)
                           + load_i^2 common_rate (cm^2 + cs^2)] T
        Cov(ln S_Ti, ln S_Tj) = [sigma_i sigma_j corr_ij
                           + load_i load_j common_rate (cm^2 + cs^2)] T

    Use the ``CorrelatedMerton`` factory for the views.
    """

    @property
    def _param_slots(self):
        # The rates enter through discrete counts and corr through the
        # fixed Cholesky factor: both excluded.
        slots = tuple(
            f"{p}[{i}]"
            for p in ("s0", "mu", "sigma", "jump_mean", "jump_std", "loadings")
            for i in range(self.d)
        )
        if self.common_rate > 0:
            slots = slots + ("common_mean", "common_std")
        return slots

    def __init__(
        self, s0, mu, sigma, corr, jump_rate=1.0, jump_mean=0.0, jump_std=0.1,
        common_rate=0.0, common_mean=0.0, common_std=0.0, loadings=1.0, T=1.0, steps=252,
    ):
        from probabilit_tpu_torch.ops.copulas import corr_cholesky

        d, corr, p = self._asset_params(
            "CorrelatedMerton", s0, corr, mu=mu, sigma=sigma, jump_rate=jump_rate,
            jump_mean=jump_mean, jump_std=jump_std, loadings=loadings,
        )
        if not (p["s0"] > 0).all():
            raise ValueError("Every s0 must be positive.")
        if not (p["sigma"] > 0).all():
            raise ValueError("Every sigma must be positive.")
        if not (p["jump_rate"] >= 0).all():
            raise ValueError("Every jump_rate must be >= 0.")
        if not (p["jump_std"] >= 0).all():
            raise ValueError("Every jump_std must be >= 0.")
        common_rate, common_std = float(common_rate), float(common_std)
        if not common_rate >= 0:
            raise ValueError(f"common_rate must be >= 0, got {common_rate}.")
        if not common_std >= 0:
            raise ValueError(f"common_std must be >= 0, got {common_std}.")
        chol, _ = corr_cholesky(corr)
        self.s0 = p["s0"]
        self.mu = p["mu"]
        self.sigma = p["sigma"]
        self.jump_rate = p["jump_rate"]
        self.jump_mean = p["jump_mean"]
        self.jump_std = p["jump_std"]
        self.loadings = p["loadings"]
        self.common_rate = common_rate
        self.common_mean = float(common_mean)
        self.common_std = common_std
        self.corr = corr
        self._chol = chol
        self.d = d
        super().__init__(steps, T)

    def __repr__(self):
        return (
            f"CorrelatedMertonPaths(d={self.d}, common_rate="
            f"{self.common_rate:g}, T={self.T:g}, steps={self.steps})"
        )

    def _static_signature(self):
        return (
            "CorrelatedMertonPaths", self.s0.tobytes(), self.mu.tobytes(),
            self.sigma.tobytes(), self.jump_rate.tobytes(), self.jump_mean.tobytes(),
            self.jump_std.tobytes(), self.loadings.tobytes(), self.common_rate,
            self.common_mean, self.common_std, self.corr.tobytes(), self.T, self.steps,
        )

    @property
    def _q_width(self):
        # Per (asset, step): diffusion normal, jump-count uniform and
        # summed-jump normal; one shared count/size pair a step when the
        # common stream is on.
        w = 3 * self.d * self.steps
        return w + (2 * self.steps if self.common_rate > 0 else 0)

    def _idio_counts(self, u):
        """(n, steps, d) jump counts, one static-rate Poisson inverse CDF
        per asset (the CDF-table branch); zero-rate assets draw none."""
        dt = self.T / self.steps
        cols = []
        for a in range(self.d):
            rate = float(self.jump_rate[a])
            if rate == 0.0:
                cols.append(torch.zeros(u.shape[:2], dtype=u.dtype, device=u.device))
            else:
                cols.append(poisson_counts(u[:, :, a], rate * dt))
        return torch.stack(cols, dim=2)

    def _increments(self, gen, n, dtype):
        dt = self.T / self.steps
        shape = (n, self.steps, self.d)
        z = normal(gen, shape, dtype)
        k_idio = self._idio_counts(uniform(gen, shape, dtype))
        zj = normal(gen, shape, dtype)
        if self.common_rate > 0:
            k_common = poisson_counts(uniform(gen, shape[:2], dtype), self.common_rate * dt)
            zc2 = normal(gen, shape[:2], dtype)
        else:
            k_common = zc2 = None
        return self._combine(z, k_idio, zj, k_common, zc2, dtype)

    def _increments_from_slab(self, slab, dtype):
        # Slab layout [d bridged diffusion blocks | d count blocks | d size
        # blocks | common count | common size], asset-major in each part.
        s, d = self.steps, self.d
        dt = self.T / s
        z = _stack_bridged(slab, 0, d, s, dtype)
        u = torch.stack(
            [slab[:, (d + a) * s : (d + a + 1) * s].to(dtype) for a in range(d)], dim=2
        )
        k_idio = self._idio_counts(u)
        zj = torch.stack(
            [
                _special.ndtri_fast(slab[:, (2 * d + a) * s : (2 * d + a + 1) * s].to(dtype))
                for a in range(d)
            ],
            dim=2,
        )
        if self.common_rate > 0:
            off = 3 * d * s
            k_common = poisson_counts(slab[:, off : off + s].to(dtype), self.common_rate * dt)
            zc2 = _special.ndtri_fast(slab[:, off + s :].to(dtype))
        else:
            k_common = zc2 = None
        return self._combine(z, k_idio, zj, k_common, zc2, dtype)

    def _combine(self, z, k_idio, zj, k_common, zc2, dtype):
        dt = self.T / self.steps

        def vec(x):
            return torch.as_tensor(x, dtype=dtype, device=z.device)

        zc = _recolor_assets(z, self._chol)
        drift = vec((self.mu - 0.5 * self.sigma**2) * dt)
        vol = vec(self.sigma * dt**0.5)
        inc = drift + vol * zc + vec(self.jump_mean) * k_idio + vec(self.jump_std) * torch.sqrt(k_idio) * zj
        if k_common is not None:
            # (n, steps) summed common jump sizes.
            common = self.common_mean * k_common + self.common_std * torch.sqrt(k_common) * zc2
            inc = inc + vec(self.loadings) * common[:, :, None]
        return inc  # (n, steps, d) log-increments


def CorrelatedMerton(
    s0, mu, sigma, corr, jump_rate=1.0, jump_mean=0.0, jump_std=0.1, common_rate=0.0,
    common_mean=0.0, common_std=0.0, loadings=1.0, T=1.0, steps=252,
):
    """d correlated Merton jump-diffusions from one exact joint draw, with
    an optional common jump stream (see :class:`CorrelatedMertonPaths`);
    one :class:`AssetPath` view per asset:

    >>> a, b = CorrelatedMerton([100, 50], [0.03, 0.02], [0.2, 0.3],
    ...                         [[1, 0.5], [0.5, 1]], jump_rate=[0.5, 1.0],
    ...                         jump_mean=-0.05, common_rate=0.2,
    ...                         common_mean=-0.1, common_std=0.05, steps=16)
    >>> basket = 0.5 * a.terminal() + 0.5 * b.terminal()
    """
    return CorrelatedMertonPaths(
        s0, mu, sigma, corr, jump_rate=jump_rate, jump_mean=jump_mean, jump_std=jump_std,
        common_rate=common_rate, common_mean=common_mean, common_std=common_std,
        loadings=loadings, T=T, steps=steps,
    ).views()
