"""Importance sampling by exponential tilting in quantile space.

Port of ``probabilit_tpu/engine/importance.py``.  Every distribution node
draws ``x = F^{-1}(u)`` from a uniform quantile ``u``, so instead of
tilting ``x`` (a target pdf, a proposal pdf, family-specific math) the
QUANTILE is tilted: ``u`` is drawn from a polynomial proposal on (0, 1)
whose density is known in closed form, and weighted by its reciprocal.
For any integrable ``h``::

    E[h(X)] = int_0^1 h(F^{-1}(u)) du = E_g[h(F^{-1}(U)) / g(U)]

with ``U ~ g``.  One formula covers every family, and the proposal and
weight are ordinary graph nodes (two uniforms, ``Floor``, ``Log``,
``Expm1``, ``Exp`` and a ``QuantileTransform``), so ``tilted`` composes
with ``estimate`` streaming, ``method=`` sequences and replicates.

Proposals (``k >= 1`` concentrates samples into the tail; ``k = 1`` is
plain Monte Carlo):

- ``tail="lower"``:  ``U = 1 - (1-V)^{1/k}``, density
  ``g(u) = k (1-u)^{k-1}``: mass piles up near ``u = 0``.
- ``tail="upper"``:  ``U = V^{1/k}``, density ``g(u) = k u^{k-1}``:
  mass piles up near ``u = 1``.

The lower tilt is computed as ``u = -expm1(log(1-v)/k)``, exact down to
denormals: in float32 it resolves tail probabilities to ~1e-38 (the
``QuantileTransform`` clamps at the float's normal-range floor and the
wide ppfs of ``ops/ppf.py`` resolve them).  Its depth variable
``a = -log(1-v)`` is built from TWO stacked uniforms (a ~48-bit-deep
1-v), so ``a`` reaches ~33.3 before saturating: the tilt stays unbiased
as long as ``k * p_true < ~30``.  The upper tilt represents ``u`` near
one, where float32 quantises at 2^-24: upper-tail events rarer than
~1e-6 need ``config.set_dtype(torch.float64)`` or a lower-tail
reformulation of the model (negate the driver).

No kernel takes a tilted graph: ``QuantileTransform`` is outside
``cuda_exec.supports``, as it is outside the TPU kernel's
``pallas_exec.supports``, so ``estimate`` of a tilted node runs the
plain executor, on the card by default.
"""

import math
import warnings

import numpy as np

__all__ = ["tilted", "suggest_tilt", "wide_families"]

# A tilt exponent k concentrates the proposal's quantiles at depth
# ~1/k.  Below 2^-24 the float32 uniform grid (upper tail) and the
# standard ppfs (non-wide families) both break down, so deep tilts past
# this point need the wide ppfs and/or float64.
_F32_DEPTH_LIMIT = 2.0**24


def wide_families():
    """Names of the families with deep-tail-accurate ppfs.

    Only these families give correct values for quantiles below the
    ~2^-24 resolution of the standard ppfs; ``tilted`` warns when a deep
    tilt (k > 2^24) targets any other family.
    """
    from probabilit_tpu_torch.ops import ppf

    return sorted(ppf._WIDE_REGISTRY)


def tilted(distr, k, *args, tail="lower", **kwargs):
    """(x, w): a tilted draw from ``distr`` and its unbiased IS weight.

    ``x`` follows the PROPOSAL law (its quantile is drawn from the
    polynomial tilt above instead of uniformly); ``w`` is the likelihood
    ratio with ``E[h(x_target)] = E[h(x) * w]`` for every integrable
    ``h``::

        x, w = tilted("norm", k=suggest_tilt(1e-9), tail="lower")
        p = estimate((x < -6.0) * w, 10**6)["mean"]   # P(X < -6)

    At the suggested ``k`` the estimator's relative variance is ~0.54 per
    draw however small ``p`` is (see ``suggest_tilt``).  ``distr``,
    ``*args`` and ``**kwargs`` name a scipy.stats family as
    ``Distribution`` does (node-valued parameters included).
    ``estimate(w, n)["mean"] ~= 1`` is a diagnostic, as is the effective
    sample size ``n * E[w]^2 / E[w^2]``.

    With ``v`` the underlying uniform the lower tilt has
    ``1-u = (1-v)^{1/k}``, so ``w = (1-u)^{1-k}/k = exp(log(1-v) *
    (1-k)/k) / k``, evaluated in log space from the stacked-uniform depth
    with no cancellation; the upper tilt mirrors it with ``log(v)``.  Any
    ``k > 0`` is unbiased in exact arithmetic, but in float32 an
    overshot lower tilt (``k * p_true > ~30``) truncates the event region
    and biases LOW: when the rarity guess is uncertain, err toward the
    common side (smaller k), which only costs variance.
    """
    from probabilit_tpu_torch.models.distributions import Distribution, QuantileTransform
    from probabilit_tpu_torch.models.graph import Exp, Expm1, Floor, Log

    k = float(k)
    if not (math.isfinite(k) and k > 0.0):
        raise ValueError(f"tilt exponent k must be finite and > 0, got {k}.")
    if tail not in ("lower", "upper"):
        raise ValueError(f"tail must be 'lower' or 'upper', got {tail!r}.")
    if k > _F32_DEPTH_LIMIT:
        from probabilit_tpu_torch import config
        from probabilit_tpu_torch.ops import ppf as _ppf

        if tail == "upper" and config.np_float_dtype() == np.float32:
            warnings.warn(
                f"tilted(tail='upper', k={k:.3g}) targets quantile depths"
                f" below the float32 grid near u = 1 (~2^-24): the tilted"
                f" uniforms quantise and the estimate is silently biased"
                f" (the E[w] ~ 1 diagnostic degenerates too).  Use"
                f" config.set_dtype('float64'), or reformulate as a"
                f" lower-tail tilt by negating/inverting the driver"
                f" (exact to ~1e-38 in float32).",
                stacklevel=2,
            )
        if distr not in _ppf._WIDE_REGISTRY:
            warnings.warn(
                f"tilted('{distr}', k={k:.3g}): this family has no"
                f" deep-tail ppf kernel, and its standard kernel returns"
                f" silently wrong values for quantiles below ~2^-24 —"
                f" tail estimates this deep are unreliable.  Families"
                f" with wide kernels: {wide_families()}.",
                stacklevel=2,
            )
    if tail == "lower":
        # 1-V = (J + V2) * 2^-24 with J = floor(V1 * (2^24 - 1)) a uniform
        # integer (the -1 keeps J >= 0 under the generators' open-interval
        # clamp): a = -log(1-V) reaches ~33.3 where one float32 uniform
        # stops at ln(2^24) ~ 16.6, with O(2^-24) relative law distortion.
        # Only log(J + V2) is formed, so nothing cancels at any depth.
        v1 = Distribution("uniform")
        v2 = Distribution("uniform")
        log_tail = Log(Floor(v1 * (2.0**24 - 1.0)) + v2) - 24.0 * math.log(2.0)
        u = -Expm1(log_tail / k)  # 1 - (1-v)^{1/k}, exact near u = 0
    else:
        log_tail = Log(Distribution("uniform"))
        u = Exp(log_tail / k)  # v^{1/k}
    w = Exp(log_tail * ((1.0 - k) / k)) / k
    x = QuantileTransform(u, distr, *args, **kwargs)
    return x, w


def suggest_tilt(p):
    """Variance-optimal tilt exponent ``k`` for a tail probability ~p.

    For ``Z = 1{tail} * w`` on a quantile-space tail of mass ``p``, the
    second moment under the tilt-k proposal is (``a = -log(1-p)``)::

        m(k) = E_g[Z^2] = (e^{a(k-2)} - 1) / (k (k-2)),   m(2) = a/2

    and this returns its argmin (a coarse log grid, then 60 golden-section
    steps: host arithmetic, as in the JAX package).  For small p the
    optimum is ``k* ~= 1.5936 / p``, where the relative second moment is
    ~1.54: a per-draw relative variance of ~0.54 however rare the event.
    Any ``k > 0`` is unbiased, so a rough guess of ``p`` is fine (10x off
    either way costs under 3x in variance); in float32 guess toward the
    common side (see ``tilted``).
    """
    p = float(p)
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be a probability in (0, 1), got {p}.")
    a = -math.log1p(-p)

    def second_moment(k):
        x = a * (k - 2.0)
        if abs(x) < 1e-12:
            return a / 2.0 * (1.0 + x / 2.0)
        return math.expm1(x) / (k * (k - 2.0))

    # Unimodal in k on (0, inf): bracket around the asymptotic optimum.
    ks = np.geomspace(max(1.0, 0.01 / a), 100.0 / a, 400)
    coarse = ks[int(np.argmin([second_moment(float(k)) for k in ks]))]
    lo, hi = coarse / 1.5, coarse * 1.5
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    for _ in range(60):
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        if second_moment(m1) <= second_moment(m2):
            hi = m2
        else:
            lo = m1
    return (lo + hi) / 2.0
