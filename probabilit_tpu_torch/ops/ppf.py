"""Inverse-CDF (ppf) functions per distribution family, in PyTorch.

Port of ``probabilit_tpu/ops/ppf.py``, with its four tiers and its host
callback:

1. closed forms (``uniform``, ``norm``, ``truncnorm``, ``genextreme``, ...,
   and the discrete ``bernoulli``, ``geom`` and ``randint``);
2. Newton inversions of the incomplete gamma and beta functions
   (``gamma``, ``beta``, ``t``, ``f``, ..., ``ops/special.py``), and
   safeguarded Newton on a closed-form CDF (``invgauss``, ``cosine``,
   ``exponnorm``, ...: ``special.continuous_ppf_newton``);
3. the discrete CDF tables: ``poisson``, ``binom`` and ``nbinom`` search a
   float64 CDF table built by scipy on the host when their parameters are
   numbers, and bisect their analytic CDF when the parameters are tensors
   (composite distributions); every other scipy discrete family with
   numeric parameters and a reachable support of at most 4,096 values
   gets a generic table (``static_cdf_table``);
4. every other scipy continuous family with numeric parameters: a
   monotone cubic (PCHIP) quantile table in normal-score space, built on
   the host (``static_quantile_table``) and evaluated with one gather and
   a cubic per sample (``_pchip_ppf``).

What is left (a family without a function here whose parameters are
tensors, or whose table does not fit) goes to scipy on the host
(``scipy_fallback_ppf``), as the JAX package's ``jax.pure_callback``
does: right, and a round trip to the host on every call.  ``call``
dispatches in that order.

Each is ``ppf(q, *shape_params, loc, scale)`` with scipy.stats' parameter
names, order and defaults.  Powers go through ``special.pow``, so that no
value depends on the batch it was computed in.  Parameters may be
tensors or numbers; both broadcast elementwise, in float32 or float64.

The score shortcuts (``score_call``, ``score_emit``) evaluate
``ppf(ndtr(y))`` in closed form for the score-linear families (norm,
lognorm), as ``probabilit_tpu/ops/ppf.py:151-190`` does for the
correlated paths.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import special

__all__ = [
    "register",
    "lookup",
    "call",
    "families",
    "static_cdf_table",
    "static_quantile_table",
    "scipy_fallback_ppf",
    "scipy_fallback_rvs",
    "is_multivariate",
    "register_wide",
    "call_wide",
    "score_call",
    "score_emit",
]

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def lookup(name):
    return _REGISTRY.get(name)


# Deep-tail variants for DERIVED quantiles (``QuantileTransform``): the
# generators' uniforms never fall below the 2^-24 float32 grid, so the hot
# path's ppfs may saturate there; a quantile computed by a graph (a copula
# marginal, a tilt) can be far smaller, and a family registered here
# resolves it down to the float's normal range (~1e-37 in float32).
_WIDE_REGISTRY = {}


def register_wide(name):
    def deco(fn):
        _WIDE_REGISTRY[name] = fn
        return fn

    return deco


def call_wide(name, q, *args, **kwargs):
    """``call``, with the family's deep-tail ppf where it has one."""
    kernel = _WIDE_REGISTRY.get(name)
    if kernel is not None:
        return kernel(q, *args, **kwargs)
    return call(name, q, *args, **kwargs)


def families():
    """The names of the ported families, sorted."""
    return sorted(_REGISTRY)


def call(name, q, *args, **kwargs):
    """Evaluate the ppf of scipy.stats distribution ``name`` at ``q``: its
    registered function, else a static CDF table, else a PCHIP quantile
    table, else scipy on the host."""
    kernel = lookup(name)
    if kernel is None:
        built = static_cdf_table(name, *args, **kwargs)
        if built is not None:
            table, start = built
            return _table_ppf(q, table, loc=start)
        quantile_table = static_quantile_table(name, *args, **kwargs)
        if quantile_table is not None:
            return _pchip_ppf(q, quantile_table)
        return scipy_fallback_ppf(name, q, *args, **kwargs)
    return kernel(q, *args, **kwargs)


def _f(x):
    """Promote a parameter to the configured float dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(config.float_dtype())
    return torch.tensor(x, dtype=config.float_dtype())


def _is_static(*params):
    return all(isinstance(p, (numbers.Number, np.ndarray)) for p in params)


_PI = math.pi
_SQRT2PI = 2.5066282746310002
_INV_SQRT2PI = 0.3989422804014327


# ---------------------------------------------------------------------
# Continuous, closed form
# ---------------------------------------------------------------------


@register("uniform")
def uniform(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(q)


@register("norm")
def norm(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.ndtri_fast(_f(q))


@register("expon")
def expon(q, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * torch.log1p(-_f(q))


@register("lognorm")
def lognorm(q, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(_f(s) * special.ndtri_fast(_f(q)))


@register_wide("norm")
def norm_wide(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.ndtri_fast_wide(_f(q))


@register_wide("lognorm")
def lognorm_wide(q, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(_f(s) * special.ndtri_fast_wide(_f(q)))


@register("triang")
def triang(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    left = torch.sqrt(q * c)
    right = 1.0 - torch.sqrt((1.0 - q) * (1.0 - c))
    x = torch.where(q <= c, left, right)
    return _f(loc) + _f(scale) * x


@register("truncnorm")
def truncnorm(q, a, b, loc=0.0, scale=1.0):
    # The CDF form loses resolution for windows in the upper tail, the
    # survival form in the lower: select by the window's midpoint.
    a, b, q = _f(a), _f(b), _f(q)
    fa, fb = special.ndtr_fast(a), special.ndtr_fast(b)
    x_cdf = special.ndtri_fast_wide(fa + q * (fb - fa))
    sa, sb = special.ndtr_neg_fast(a), special.ndtr_neg_fast(b)
    x_sf = -special.ndtri_fast_wide(sa + q * (sb - sa))
    x = torch.where(a + b > 0, x_sf, x_cdf)
    x = torch.minimum(torch.maximum(x, a), b)  # rounding never leaves the support
    return _f(loc) + _f(scale) * x


@register("cauchy")
def cauchy(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.tan(_PI * (_f(q) - 0.5))


@register("laplace")
def laplace(q, loc=0.0, scale=1.0):
    q = _f(q)
    x = torch.where(q < 0.5, torch.log(2.0 * q), -torch.log(2.0 * (1.0 - q)))
    return _f(loc) + _f(scale) * x


@register("logistic")
def logistic(q, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * (torch.log(q) - torch.log1p(-q))


@register("gumbel_r")
def gumbel_r(q, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * torch.log(-torch.log(_f(q)))


@register("gumbel_l")
def gumbel_l(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.log(-torch.log1p(-_f(q)))


@register("rayleigh")
def rayleigh(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.sqrt(-2.0 * torch.log1p(-_f(q)))


@register("halfnorm")
def halfnorm(q, loc=0.0, scale=1.0):
    # -ndtri((1 - q) / 2) keeps precision as q -> 1.
    q = _f(q)
    return _f(loc) - _f(scale) * special.ndtri_fast_wide(0.5 * (1.0 - q))


@register("pareto")
def pareto(q, b, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.pow(1.0 - _f(q), -1.0 / _f(b))


@register("weibull_min")
def weibull_min(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.pow(-torch.log1p(-_f(q)), 1.0 / _f(c))


@register("weibull_max")
def weibull_max(q, c, loc=0.0, scale=1.0):
    return _f(loc) - _f(scale) * special.pow(-torch.log(_f(q)), 1.0 / _f(c))


@register("powerlaw")
def powerlaw(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.pow(_f(q), 1.0 / _f(a))


@register("loguniform")
def loguniform(q, a, b, loc=0.0, scale=1.0):
    a, b = _f(a), _f(b)
    return _f(loc) + _f(scale) * torch.exp(
        torch.log(a) + _f(q) * (torch.log(b) - torch.log(a))
    )


@register("reciprocal")
def reciprocal(q, a, b, loc=0.0, scale=1.0):
    """scipy's alias of ``loguniform``."""
    return loguniform(q, a, b, loc=loc, scale=scale)


@register("arcsine")
def arcsine(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.square(torch.sin(0.5 * _PI * _f(q)))


@register("hypsecant")
def hypsecant(q, loc=0.0, scale=1.0):
    # tan(pi q / 2) loses precision as q -> 1: reflect onto the lower half.
    q = _f(q)
    tail = torch.minimum(q, 1.0 - q)
    mag = torch.log(torch.tan(0.5 * _PI * tail))
    return _f(loc) + _f(scale) * torch.where(q < 0.5, mag, -mag)


@register("fisk")
def fisk(q, c, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * special.pow(q / (1.0 - q), 1.0 / _f(c))


def _safe_divisor(c, small):
    return torch.where(small, 1.0, c)


@register("genpareto")
def genpareto(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    small = torch.abs(c) < 1e-9
    x = torch.where(
        small,
        -torch.log1p(-q),
        special.expm1_safe(-c * torch.log1p(-q)) / _safe_divisor(c, small),
    )
    return _f(loc) + _f(scale) * x


@register("genextreme")
def genextreme(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    lq = -torch.log(q)
    small = torch.abs(c) < 1e-9
    x = torch.where(
        small,
        -torch.log(lq),
        -special.expm1_safe(c * torch.log(lq)) / _safe_divisor(c, small),
    )
    return _f(loc) + _f(scale) * x


@register("semicircular")
def semicircular(q, loc=0.0, scale=1.0):
    # CDF(x) = 1/2 + (x sqrt(1 - x^2) + arcsin x) / pi on [-1, 1]: 16 Newton steps.
    q = _f(q)
    x = 2.0 * q - 1.0
    for _ in range(16):
        f = 0.5 + (x * torch.sqrt(1.0 - x * x) + torch.arcsin(x)) / _PI - q
        pdf = 2.0 * torch.sqrt(torch.clamp(1.0 - x * x, min=1e-12)) / _PI
        x = torch.clamp(x - f / pdf, -1.0, 1.0)
    return _f(loc) + _f(scale) * x


# ---------------------------------------------------------------------
# Continuous, Newton inversions of the incomplete gamma and beta functions
# ---------------------------------------------------------------------


@register("gamma")
def gamma(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.gammaincinv(_f(a), _f(q))


@register("erlang")
def erlang(q, a, loc=0.0, scale=1.0):
    return gamma(q, a, loc=loc, scale=scale)


@register("chi2")
def chi2(q, df, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * 2.0 * special.gammaincinv(0.5 * _f(df), _f(q))


@register("chi")
def chi(q, df, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.sqrt(2.0 * special.gammaincinv(0.5 * _f(df), _f(q)))


@register("maxwell")
def maxwell(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.sqrt(2.0 * special.gammaincinv(_f(1.5), _f(q)))


@register("invgamma")
def invgamma(q, a, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) / special.gammaincinv(_f(a), 1.0 - _f(q))


@register("nakagami")
def nakagami(q, nu, loc=0.0, scale=1.0):
    nu = _f(nu)
    return _f(loc) + _f(scale) * torch.sqrt(special.gammaincinv(nu, _f(q)) / nu)


@register("beta")
def beta(q, a, b, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.betaincinv(_f(a), _f(b), _f(q))


@register("betaprime")
def betaprime(q, a, b, loc=0.0, scale=1.0):
    x = special.betaincinv(_f(a), _f(b), _f(q))
    return _f(loc) + _f(scale) * x / (1.0 - x)


@register("t")
def t(q, df, loc=0.0, scale=1.0):
    # Two-tailed inversion through the incomplete beta function.
    q, df = _f(q), _f(df)
    tail = torch.minimum(q, 1.0 - q)
    x = special.betaincinv(0.5 * df, _f(0.5), 2.0 * tail)
    tval = torch.sqrt(df * (1.0 - x) / torch.clamp(x, min=1e-30))
    return _f(loc) + _f(scale) * torch.where(q < 0.5, -tval, tval)


@register("f")
def f(q, dfn, dfd, loc=0.0, scale=1.0):
    q, dfn, dfd = _f(q), _f(dfn), _f(dfd)
    x = special.betaincinv(0.5 * dfn, 0.5 * dfd, q)
    return _f(loc) + _f(scale) * (dfd * x) / (dfn * (1.0 - x))


@register("invgauss")
def invgauss(q, mu, loc=0.0, scale=1.0):
    """Inverse Gaussian: Newton on Shuster's (1968) closed-form CDF.

    F(x; mu) = ndtr((x/mu - 1)/sqrt(x)) + exp(2/mu) ndtr(-(x/mu + 1)/sqrt(x)),
    the product taken through the scaled CDF so that it never overflows.
    """
    q, mu = _f(q), _f(mu)

    def cdf(x):
        rx = torch.rsqrt(torch.clamp(x, min=1e-30))
        a = (x / mu - 1.0) * rx
        b = -(x / mu + 1.0) * rx
        return special.ndtr_fast(a) + torch.exp(-0.5 * a * a) * special.ndtr_scaled_neg(b)

    def pdf(x):
        xc = torch.clamp(x, min=1e-30)
        return torch.exp(
            -0.5 * torch.log(2.0 * _PI * xc**3) - torch.square(xc - mu) / (2.0 * mu * mu * xc)
        )

    x0 = torch.broadcast_to(mu, torch.broadcast_shapes(q.shape, mu.shape))
    hi = mu * (1.0 + 50.0 * (1.0 + mu))
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 1e-12, hi)
    return _f(loc) + _f(scale) * x


@register("wald")
def wald(q, loc=0.0, scale=1.0):
    """Wald: the inverse Gaussian with mu = 1."""
    return invgauss(q, 1.0, loc=loc, scale=scale)


# ---------------------------------------------------------------------
# Continuous, closed form: the wider scipy coverage
# ---------------------------------------------------------------------


@register("alpha")
def alpha(q, a, loc=0.0, scale=1.0):
    # CDF = ndtr(a - 1/x) / ndtr(a) on x > 0; past q = 1 - 1e-3 the
    # first-order tail form, whose (1 - q) is exact.
    a, q = _f(a), _f(q)
    x = 1.0 / (a - special.ndtri_fast_wide(q * special.ndtr_fast(a)))
    phi_a = _INV_SQRT2PI * torch.exp(-0.5 * a * a)
    D = special.ndtr_fast(a) * (1.0 - q) / phi_a
    x_tail = 1.0 / (D * (1.0 - 0.5 * a * D))
    x = torch.where(q > 1.0 - 1e-3, x_tail, x)
    return _f(loc) + _f(scale) * x


@register("anglit")
def anglit(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * (torch.arcsin(torch.sqrt(_f(q))) - 0.25 * _PI)


@register("bradford")
def bradford(q, c, loc=0.0, scale=1.0):
    c = _f(c)
    return _f(loc) + _f(scale) * special.expm1_safe(_f(q) * torch.log1p(c)) / c


@register("burr")
def burr(q, c, d, loc=0.0, scale=1.0):
    # Burr III, CDF = (1 + x^-c)^-d; log1p(q - 1) stays relative-accurate
    # as q -> 1 (q - 1 is exact).
    q, c, d = _f(q), _f(c), _f(d)
    x = special.pow(special.expm1_safe(-torch.log1p(q - 1.0) / d), -1.0 / c)
    return _f(loc) + _f(scale) * x


@register("burr12")
def burr12(q, c, d, loc=0.0, scale=1.0):
    # Burr XII, SF = (1 + x^c)^-d.
    q, c, d = _f(q), _f(c), _f(d)
    x = special.pow(special.expm1_safe(-torch.log1p(-q) / d), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("dgamma")
def dgamma(q, a, loc=0.0, scale=1.0):
    # Reflected gamma: CDF = Q(a, -x)/2 left of 0, 1/2 + P(a, x)/2 right of it.
    q, a = _f(q), _f(a)
    eps = 1e-7
    low = -special.gammainccinv(a, torch.clamp(2.0 * q, eps, 1.0))
    high = special.gammaincinv(a, torch.clamp(2.0 * q - 1.0, 0.0, 1.0 - eps))
    return _f(loc) + _f(scale) * torch.where(q < 0.5, low, high)


@register("dweibull")
def dweibull(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    eps = 1e-12
    mag_low = special.pow(-torch.log(torch.clamp(2.0 * q, min=eps)), 1.0 / c)
    mag_high = special.pow(-torch.log(torch.clamp(2.0 * (1.0 - q), min=eps)), 1.0 / c)
    return _f(loc) + _f(scale) * torch.where(q < 0.5, -mag_low, mag_high)


@register("exponpow")
def exponpow(q, b, loc=0.0, scale=1.0):
    # CDF = 1 - exp(1 - exp(x^b)).
    x = special.pow(torch.log1p(-torch.log1p(-_f(q))), 1.0 / _f(b))
    return _f(loc) + _f(scale) * x


@register("exponweib")
def exponweib(q, a, c, loc=0.0, scale=1.0):
    # CDF = (1 - exp(-x^c))^a; 1 - q^(1/a) as -expm1(log1p(q - 1)/a).
    q, a, c = _f(q), _f(a), _f(c)
    t = -special.expm1_safe(torch.log1p(q - 1.0) / a)
    x = special.pow(-torch.log(t), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("fatiguelife")
def fatiguelife(q, c, loc=0.0, scale=1.0):
    # Birnbaum-Saunders: x = ((c z + sqrt(c^2 z^2 + 4)) / 2)^2.
    t = _f(c) * special.ndtri_fast(_f(q))
    return _f(loc) + _f(scale) * 0.25 * torch.square(t + torch.sqrt(t * t + 4.0))


@register("genhalflogistic")
def genhalflogistic(q, c, loc=0.0, scale=1.0):
    # CDF = (1 - t) / (1 + t), t = (1 - c x)^(1/c) on [0, 1/c].
    q, c = _f(q), _f(c)
    t = (1.0 - q) / (1.0 + q)
    return _f(loc) + _f(scale) * (1.0 - special.pow(t, c)) / c


@register("genlogistic")
def genlogistic(q, c, loc=0.0, scale=1.0):
    # CDF = (1 + exp(-x))^-c.
    q = _f(q)
    x = -torch.log(special.expm1_safe(-torch.log1p(q - 1.0) / _f(c)))
    return _f(loc) + _f(scale) * x


@register("gengamma")
def gengamma(q, a, c, loc=0.0, scale=1.0):
    q, a, c = _f(q), _f(a), _f(c)
    val = torch.where(c > 0, special.gammaincinv(a, q), special.gammainccinv(a, q))
    return _f(loc) + _f(scale) * special.pow(val, 1.0 / c)


@register("gennorm")
def gennorm(q, beta, loc=0.0, scale=1.0):
    q, beta = _f(q), _f(beta)
    mag = special.pow(special.gammaincinv(1.0 / beta, torch.abs(2.0 * q - 1.0)), 1.0 / beta)
    return _f(loc) + _f(scale) * torch.sign(q - 0.5) * mag


@register("halfgennorm")
def halfgennorm(q, beta, loc=0.0, scale=1.0):
    beta = _f(beta)
    return _f(loc) + _f(scale) * special.pow(special.gammaincinv(1.0 / beta, _f(q)), 1.0 / beta)


@register("gibrat")
def gibrat(q, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(special.ndtri_fast(_f(q)))


@register("gompertz")
def gompertz(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.log1p(-torch.log1p(-_f(q)) / _f(c))


@register("halfcauchy")
def halfcauchy(q, loc=0.0, scale=1.0):
    # The cotangent of the complementary angle stays exact as q -> 1.
    q = _f(q)
    return _f(loc) + _f(scale) / torch.tan(0.5 * _PI * (1.0 - q))


@register("halflogistic")
def halflogistic(q, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * (torch.log1p(q) - torch.log1p(-q))


@register("invweibull")
def invweibull(q, c, loc=0.0, scale=1.0):
    q = _f(q)
    return _f(loc) + _f(scale) * special.pow(-torch.log1p(q - 1.0), -1.0 / _f(c))


@register("johnsonsb")
def johnsonsb(q, a, b, loc=0.0, scale=1.0):
    z = (special.ndtri_fast(_f(q)) - _f(a)) / _f(b)
    return _f(loc) + _f(scale) / (1.0 + torch.exp(-z))


@register("johnsonsu")
def johnsonsu(q, a, b, loc=0.0, scale=1.0):
    # sinh through exp, as the TPU kernel writes it.
    z = (special.ndtri_fast(_f(q)) - _f(a)) / _f(b)
    ez = torch.exp(z)
    return _f(loc) + _f(scale) * 0.5 * (ez - 1.0 / ez)


@register("kappa3")
def kappa3(q, a, loc=0.0, scale=1.0):
    # x = (a q^a / (1 - q^a))^(1/a), the ratio as exp(z) / -expm1(z).
    q, a = _f(q), _f(a)
    z = a * torch.log1p(q - 1.0)
    ratio = torch.exp(z) / (-special.expm1_safe(z))
    return _f(loc) + _f(scale) * special.pow(a * ratio, 1.0 / a)


@register("laplace_asymmetric")
def laplace_asymmetric(q, kappa, loc=0.0, scale=1.0):
    q, kappa = _f(q), _f(kappa)
    k2 = kappa * kappa
    split = k2 / (1.0 + k2)
    low = kappa * torch.log(torch.clamp(q * (1.0 + k2) / k2, min=1e-30))
    high = -torch.log(torch.clamp((1.0 - q) * (1.0 + k2), min=1e-30)) / kappa
    return _f(loc) + _f(scale) * torch.where(q < split, low, high)


@register("levy")
def levy(q, loc=0.0, scale=1.0):
    z = special.ndtri_fast_wide(0.5 * _f(q))
    return _f(loc) + _f(scale) / (z * z)


@register("levy_l")
def levy_l(q, loc=0.0, scale=1.0):
    z = special.ndtri_fast_wide(0.5 * (1.0 - _f(q)))
    return _f(loc) - _f(scale) / (z * z)


@register("loggamma")
def loggamma(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.log(special.gammaincinv(_f(c), _f(q)))


@register("loglaplace")
def loglaplace(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    low = special.pow(torch.clamp(2.0 * q, min=1e-30), 1.0 / c)
    high = special.pow(torch.clamp(2.0 * (1.0 - q), min=1e-30), -1.0 / c)
    return _f(loc) + _f(scale) * torch.where(q < 0.5, low, high)


@register("lomax")
def lomax(q, c, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * special.expm1_safe(-torch.log1p(-_f(q)) / _f(c))


@register("mielke")
def mielke(q, k, s, loc=0.0, scale=1.0):
    # CDF = x^k (1 + x^s)^(-k/s).
    q, k, s = _f(q), _f(k), _f(s)
    z = (s / k) * torch.log1p(q - 1.0)
    ratio = torch.exp(z) / (-special.expm1_safe(z))
    return _f(loc) + _f(scale) * special.pow(ratio, 1.0 / s)


@register("moyal")
def moyal(q, loc=0.0, scale=1.0):
    # CDF = erfc(exp(-x/2) / sqrt(2)):  x = -2 log(-ndtri(q/2)).
    x = -2.0 * torch.log(-special.ndtri_fast_wide(0.5 * _f(q)))
    return _f(loc) + _f(scale) * x


@register("pearson3")
def pearson3(q, skew, loc=0.0, scale=1.0):
    # gamma(alpha) / b + zeta with alpha = 4/skew^2, b = skew/2,
    # zeta = -2/skew; a negative skew flips the tail; skew == 0 is normal.
    q, skew = _f(q), _f(skew)
    safe = torch.where(torch.abs(skew) < 1e-12, 1.0, skew)
    alpha = torch.clamp(4.0 / (safe * safe), max=1e12)
    b = 2.0 / safe
    zeta = -2.0 / safe
    qq = torch.where(skew < 0, 1.0 - q, q)
    g = special.gammaincinv(alpha, qq)
    x = torch.where(torch.abs(skew) < 1e-12, special.ndtri_fast(q), g / b + zeta)
    return _f(loc) + _f(scale) * x


def _powernorm_score(q, c):
    """ndtri(w) for w = (1 - q)^(1/c), tail-stable at both ends: for
    q < 1/2 through -ndtri(1 - w) with 1 - w = -expm1(log1p(-q)/c)."""
    w = special.pow(1.0 - q, 1.0 / c)
    direct = special.ndtri_fast_wide(w)
    one_minus_w = -special.expm1_safe(torch.log1p(-q) / c)
    reflected = -special.ndtri_fast_wide(torch.clamp(one_minus_w, min=2.0**-126))
    return torch.where(q < 0.5, reflected, direct)


@register("powerlognorm")
def powerlognorm(q, c, s, loc=0.0, scale=1.0):
    # CDF = 1 - ndtr(-log(x)/s)^c.
    q, c, s = _f(q), _f(c), _f(s)
    return _f(loc) + _f(scale) * torch.exp(-s * _powernorm_score(q, c))


@register("powernorm")
def powernorm(q, c, loc=0.0, scale=1.0):
    # CDF = 1 - ndtr(-x)^c.
    q, c = _f(q), _f(c)
    return _f(loc) - _f(scale) * _powernorm_score(q, c)


@register("rdist")
def rdist(q, c, loc=0.0, scale=1.0):
    c = _f(c)
    return _f(loc) + _f(scale) * (2.0 * special.betaincinv(0.5 * c, 0.5 * c, _f(q)) - 1.0)


@register("trapezoid")
def trapezoid(q, c, d, loc=0.0, scale=1.0):
    # Rising on [0, c], flat on [c, d], falling on [d, 1]; h the plateau.
    q, c, d = _f(q), _f(c), _f(d)
    h = 2.0 / (1.0 + d - c)
    q1 = 0.5 * h * c
    q2 = h * (d - 0.5 * c)
    rise = torch.sqrt(torch.clamp(2.0 * c * q / h, min=0.0))
    flat = q / h + 0.5 * c
    fall = 1.0 - torch.sqrt(torch.clamp(2.0 * (1.0 - d) * (1.0 - q) / h, min=0.0))
    x = torch.where(q < q1, rise, torch.where(q < q2, flat, fall))
    return _f(loc) + _f(scale) * x


@register("truncexpon")
def truncexpon(q, b, loc=0.0, scale=1.0):
    x = -torch.log1p(_f(q) * special.expm1_safe(-_f(b)))
    return _f(loc) + _f(scale) * x


@register("truncpareto")
def truncpareto(q, b, c, loc=0.0, scale=1.0):
    # Pareto(b) truncated to [1, c]: CDF = (1 - x^-b) / (1 - c^-b).
    q, b, c = _f(q), _f(b), _f(c)
    x = special.pow(1.0 - q * (1.0 - special.pow(c, -b)), -1.0 / b)
    return _f(loc) + _f(scale) * x


@register("truncweibull_min")
def truncweibull_min(q, c, a, b, loc=0.0, scale=1.0):
    # weibull_min(c) truncated to [a, b], by survival interpolation.
    q, c, a, b = _f(q), _f(c), _f(a), _f(b)
    sa = torch.exp(-special.pow(a, c))
    sb = torch.exp(-special.pow(b, c))
    x = special.pow(-torch.log(sa - q * (sa - sb)), 1.0 / c)
    return _f(loc) + _f(scale) * x


@register("tukeylambda")
def tukeylambda(q, lam, loc=0.0, scale=1.0):
    q, lam = _f(q), _f(lam)
    near0 = torch.abs(lam) < 1e-7
    safe = torch.where(near0, 1.0, lam)
    general = (special.pow(q, safe) - special.pow(1.0 - q, safe)) / safe
    x = torch.where(near0, torch.log(q) - torch.log1p(-q), general)
    return _f(loc) + _f(scale) * x


@register("wrapcauchy")
def wrapcauchy(q, c, loc=0.0, scale=1.0):
    q, c = _f(q), _f(c)
    val = (1.0 - c) / (1.0 + c)
    low = 2.0 * torch.arctan(val * torch.tan(_PI * q))
    high = 2.0 * _PI - 2.0 * torch.arctan(val * torch.tan(_PI * (1.0 - q)))
    # q == 0.5: tan(float(pi/2)) flips sign; the median is pi by symmetry.
    x = torch.where(q < 0.5, low, torch.where(q > 0.5, high, _PI))
    return _f(loc) + _f(scale) * x


@register("skewcauchy")
def skewcauchy(q, a, loc=0.0, scale=1.0):
    # Two Cauchy half-bodies of widths 1 -+ a glued at 0 (CDF (1 - a)/2
    # there); past each half-body's midpoint the cotangent form.
    q, a = _f(q), _f(a)
    wl, wu = 1.0 - a, 1.0 + a
    f0 = 0.5 * wl
    up_mid = wu * torch.tan(_PI * (q - f0) / wu)
    up_tail = wu / torch.tan(_PI * (1.0 - q) / wu)
    lo_mid = wl * torch.tan(_PI * (q - f0) / wl)
    lo_tail = -wl / torch.tan(_PI * q / wl)
    upper = torch.where(q > f0 + 0.5 * wu * 0.5, up_tail, up_mid)
    lower = torch.where(q < 0.5 * f0, lo_tail, lo_mid)
    return _f(loc) + _f(scale) * torch.where(q < f0, lower, upper)


@register("kappa4")
def kappa4(q, h, k, loc=0.0, scale=1.0):
    # CDF = (1 - h (1 - k x)^(1/k))^(1/h): t = (1 - q^h)/h, x = (1 - t^k)/k,
    # with scipy's switch on exact zeros (their -log limits).
    q, h, k = _f(q), _f(h), _f(k)
    logq = torch.log(q)
    hs = torch.where(h == 0.0, 1.0, h)
    t = torch.where(h == 0.0, -logq, -special.expm1_safe(hs * logq) / hs)
    logt = torch.log(t)
    ks = torch.where(k == 0.0, 1.0, k)
    x = torch.where(k == 0.0, -logt, -special.expm1_safe(ks * logt) / ks)
    return _f(loc) + _f(scale) * x


@register("crystalball")
def crystalball(q, beta, m, loc=0.0, scale=1.0):
    """Gaussian core with a power-law left tail grafted at -beta.

    Tail mass C = m exp(-beta^2/2) / (beta (m - 1)), core mass
    D = sqrt(2 pi) ndtr(beta), N = 1/(C + D).  Below q = N C the power
    branch inverts in log space; above it x = -ndtri((1 - q)/(N sqrt(2 pi))).
    """
    q, beta, m = _f(q), _f(beta), _f(m)
    b2h = 0.5 * beta * beta
    C = m / (beta * (m - 1.0)) * torch.exp(-b2h)
    D = _SQRT2PI * special.ndtr_fast(beta)
    logN = -torch.log(C + D)
    pbeta = torch.exp(logN) * C
    logmb = torch.log(m / beta)
    L = (torch.log(q) + torch.log(m - 1.0) - logN - m * logmb + b2h) / (1.0 - m)
    x_pow = m / beta - beta - torch.exp(L)
    x_gauss = -special.ndtri_fast_wide(torch.clamp((1.0 - q) * (C + D) / _SQRT2PI, 2.0**-126, 1.0))
    return _f(loc) + _f(scale) * torch.where(q < pbeta, x_pow, x_gauss)


@register("argus")
def argus(q, chi, loc=0.0, scale=1.0):
    # SF = P(3/2, chi^2 (1 - x^2)/2) / P(3/2, chi^2/2).  As x -> 0 the
    # difference cancels; there the cubic series of the CDF in y = x^2,
    # inverted by two Newton steps.
    q, chi = _f(q), _f(chi)
    half_chi2 = 0.5 * chi * chi
    p_chi = special.gammainc_kernel(_f(1.5), half_chi2)
    u = special.gammaincinv(_f(1.5), (1.0 - q) * p_chi)
    x = torch.sqrt(torch.clamp(1.0 - u / half_chi2, min=0.0))
    a = half_chi2
    k = chi**3 * torch.exp(-a) / (_SQRT2PI * 0.5 * p_chi)
    c2, c3 = 0.25 * (a - 0.5), (0.5 * a * a - 0.5 * a - 0.125) / 6.0
    target = q / k
    y = 2.0 * target
    for _ in range(2):
        g = y * (0.5 + y * (c2 + y * c3))
        gp = 0.5 + y * (2.0 * c2 + y * 3.0 * c3)
        y = torch.clamp(y - (g - target) / gp, min=0.0)
    use_series = x * x < 0.05 / torch.clamp(a, min=1.0)
    x = torch.where(use_series, torch.sqrt(torch.clamp(y, min=0.0)), x)
    return _f(loc) + _f(scale) * x


@register("recipinvgauss")
def recipinvgauss(q, mu, loc=0.0, scale=1.0):
    # 1/X for X ~ invgauss(mu): ppf(q) = 1 / ppf_IG(1 - q).
    return _f(loc) + _f(scale) / invgauss(1.0 - _f(q), mu)


# ---------------------------------------------------------------------
# Continuous, safeguarded Newton on a closed-form CDF
# ---------------------------------------------------------------------


@register("cosine")
def cosine(q, loc=0.0, scale=1.0):
    # CDF = (pi + x + sin x) / (2 pi) on [-pi, pi].
    q = _f(q)

    def cdf(x):
        return (_PI + x + torch.sin(x)) / (2.0 * _PI)

    def pdf(x):
        return (1.0 + torch.cos(x)) / (2.0 * _PI)

    x = special.continuous_ppf_newton(cdf, pdf, q, _PI * (2.0 * q - 1.0), -_PI, _PI)
    return _f(loc) + _f(scale) * x


@register("foldnorm")
def foldnorm(q, c, loc=0.0, scale=1.0):
    # CDF = ndtr(x - c) + ndtr(x + c) - 1 on x >= 0.
    q, c = _f(q), _f(c)

    def cdf(x):
        return special.ndtr_fast(x - c) - special.ndtr_neg_fast(x + c)

    def pdf(x):
        return _INV_SQRT2PI * (
            torch.exp(-0.5 * torch.square(x - c)) + torch.exp(-0.5 * torch.square(x + c))
        )

    hi = c + 9.0
    x0 = torch.minimum(torch.maximum(c + special.ndtri_fast(q) * 0.5, _f(0.0)), hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    return _f(loc) + _f(scale) * x


@register("foldcauchy")
def foldcauchy(q, c, loc=0.0, scale=1.0):
    # CDF = (arctan(x - c) + arctan(x + c)) / pi on x >= 0; past q = 0.99
    # the series closed form x = (1 + sqrt(1 + (eps c)^2)) / eps,
    # eps = pi (1 - q).
    q, c = _f(q), _f(c)

    def cdf(x):
        return (torch.arctan(x - c) + torch.arctan(x + c)) / _PI

    def pdf(x):
        return (1.0 / (1.0 + torch.square(x - c)) + 1.0 / (1.0 + torch.square(x + c))) / _PI

    tail = torch.clamp(1.0 - q, min=1e-12)
    hi = c + 4.0 / (_PI * tail)
    x0 = torch.minimum(torch.maximum(2.0 / (_PI * tail), _f(0.0)), hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    eps = _PI * (1.0 - q)
    x_tail = (1.0 + torch.sqrt(1.0 + torch.square(eps * c))) / eps
    return _f(loc) + _f(scale) * torch.where(q > 0.99, x_tail, x)


@register("exponnorm")
def exponnorm(q, K, loc=0.0, scale=1.0):
    """Exponentially modified normal: CDF = ndtr(x) - exp(1/(2K^2) - x/K)
    ndtr(x - 1/K), the product through the scaled normal CDF."""
    q, K = _f(q), _f(K)
    kinv = 1.0 / K

    def _term(x):
        y = x - kinv
        scaled = torch.exp(-0.5 * x * x) * special.ndtr_scaled_neg(torch.clamp(y, max=0.0))
        direct = torch.exp(0.5 * kinv * kinv - x * kinv) * special.ndtr_fast(
            torch.clamp(y, min=0.0)
        )
        return torch.where(y <= 0.0, scaled, direct)

    def cdf(x):
        return special.ndtr_fast(x) - _term(x)

    def pdf(x):
        return kinv * _term(x)

    z = special.ndtri_fast(q)
    hi = 0.5 * kinv - K * torch.log1p(-q) + 9.0
    lo = z - 1.0
    x0 = torch.minimum(torch.maximum(z + K, lo), hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, lo, hi)
    return _f(loc) + _f(scale) * x


@register("genexpon")
def genexpon(q, a, b, c, loc=0.0, scale=1.0):
    # CDF = 1 - exp(E), E = -(a+b) x + (b/c)(1 - e^{-cx}); -(a+b) x <= E
    # <= -a x + b/c bracket the root.
    q, a, b, c = _f(q), _f(a), _f(b), _f(c)
    nlog1mq = -torch.log1p(-q)

    def _E(x):
        return -(a + b) * x - (b / c) * special.expm1_safe(-c * x)

    def cdf(x):
        return -special.expm1_safe(_E(x))

    def pdf(x):
        return (a - b * special.expm1_safe(-c * x)) * torch.exp(_E(x))

    lo = nlog1mq / (a + b)
    hi = (nlog1mq + b / c) / a
    x = special.continuous_ppf_newton(cdf, pdf, q, lo, lo, hi)
    return _f(loc) + _f(scale) * x


@register("kstwobign")
def kstwobign(q, loc=0.0, scale=1.0):
    """Kolmogorov's limit distribution of sqrt(n) D_n: five terms of the
    alternating SF series for x >= 0.75, the Jacobi theta form below."""
    q = _f(q)

    def _big(x):
        x2 = x * x
        s_cdf = torch.zeros_like(x)
        s_pdf = torch.zeros_like(x)
        for k in range(1, 6):
            sign = 1.0 if k % 2 == 1 else -1.0
            e = torch.exp(-2.0 * k * k * x2)
            s_cdf = s_cdf + sign * e
            s_pdf = s_pdf + sign * (k * k) * e
        return 1.0 - 2.0 * s_cdf, 8.0 * x * s_pdf

    def _small(x):
        xs = torch.clamp(x, min=1e-3)
        s_cdf = torch.zeros_like(x)
        s_pdf = torch.zeros_like(x)
        for j in (1, 3, 5):
            cj = j * j * _PI * _PI / 8.0
            e = torch.exp(-cj / (xs * xs))
            s_cdf = s_cdf + e
            s_pdf = s_pdf + e * (2.0 * cj / xs**4 - 1.0 / (xs * xs))
        return _SQRT2PI * s_cdf / xs, _SQRT2PI * s_pdf

    def cdf(x):
        return torch.where(x < 0.75, _small(x)[0], _big(x)[0])

    def pdf(x):
        return torch.where(x < 0.75, _small(x)[1], _big(x)[1])

    x0 = torch.clamp(torch.sqrt(-0.5 * torch.log(0.5 * (1.0 - q))), 0.3, 3.8)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.03, 4.0)
    return _f(loc) + _f(scale) * x


@register("rel_breitwigner")
def rel_breitwigner(q, rho, loc=0.0, scale=1.0):
    # pdf = C / (((x - rho)(x + rho)/rho)^2 + 1) on x >= 0; the CDF is the
    # imaginary part of a complex arctan.  Newton on it, and past q = 0.99
    # on -SF (no cancellation there).
    q, rho = _f(q), _f(rho)
    inv_r2 = 1.0 / (rho * rho)
    s = torch.sqrt(1.0 + inv_r2)
    C = torch.sqrt(2.0 * (1.0 + inv_r2) / (1.0 + s)) * 2.0 / _PI
    cdim = torch.complex64 if q.dtype == torch.float32 else torch.complex128
    rho_c = rho.to(cdim)
    w = torch.sqrt(torch.tensor(-1.0, dtype=cdim) + 1j / rho_c)
    root = torch.sqrt(-rho_c * (rho_c + 1j))
    amp = torch.sqrt(2.0 / (1.0 + s)) / _PI

    def imag_w_times(z):
        # Im(w z) in real arithmetic: PyTorch's vectorised complex product
        # rounds differently from its scalar loop on the CPU.
        return w.real * z.imag + w.imag * z.real

    def cdf(x):
        val = 2.0 * amp * imag_w_times(torch.atan(x.to(cdim) / root))
        return torch.clamp(val, 0.0, 1.0)

    def pdf(x):
        t = (x - rho) * (x + rho) / rho
        return C / (t * t + 1.0)

    hi = special.pow(C * rho * rho / (3.0 * torch.clamp(1.0 - q, min=1e-12)), 1.0 / 3.0) + 3.0 * (
        rho + 1.0
    )
    x0 = torch.minimum(torch.maximum(torch.broadcast_to(rho, q.shape), _f(0.0)), hi)
    x = special.continuous_ppf_newton(cdf, pdf, q, x0, 0.0, hi)
    s = 1.0 - q

    def neg_sf(x):
        z = root / torch.clamp(x, min=1e-3).to(cdim)
        return -2.0 * amp * imag_w_times(torch.atan(z))

    x_tail = special.continuous_ppf_newton(
        neg_sf, pdf, -s, torch.minimum(torch.maximum(hi - 3.0 * (rho + 1.0), rho), hi), rho, hi
    )
    return _f(loc) + _f(scale) * torch.where(q > 0.99, x_tail, x)


# ---------------------------------------------------------------------
# Discrete, closed form
# ---------------------------------------------------------------------


@register("bernoulli")
def bernoulli(q, p, loc=0):
    return (_f(q) > (1.0 - _f(p))).to(config.float_dtype()) + _f(loc)


@register("geom")
def geom(q, p, loc=0):
    # Support {1, 2, ...}: the smallest k with 1 - (1 - p)^k >= q.
    p, q = _f(p), _f(q)
    k = torch.ceil(torch.log1p(-q) / torch.log1p(-p))
    return torch.clamp(k, min=1.0) + _f(loc)


@register("randint")
def randint(q, low, high, loc=0):
    # scipy's k = ceil(q (high - low)) - 1 + low, so that exact-integer
    # quantiles land on scipy's value.
    low, high = _f(low), _f(high)
    k = torch.ceil(_f(q) * (high - low)) - 1.0 + low
    return torch.minimum(torch.maximum(k, low), high - 1.0) + _f(loc)


# ---------------------------------------------------------------------
# Discrete, CDF tables and bisection
# ---------------------------------------------------------------------


def _table_ppf(q, cdf_table, loc=0):
    """``searchsorted(table, q, side="left")``, clamped to the last index,
    plus ``loc``: scipy's discrete ppf on a float64 CDF table built on the
    host, cast to the float dtype by numpy."""
    q = _f(q)
    table = torch.from_numpy(np.asarray(cdf_table, config.np_float_dtype())).to(q.device)
    k = torch.clamp(torch.searchsorted(table, q.contiguous()), max=table.shape[0] - 1)
    return k.to(config.float_dtype()) + _f(loc)


def _poisson_cdf_table(mu):
    import scipy.stats as sps

    kmax = int(np.ceil(mu + 12.0 * np.sqrt(mu + 1.0) + 30.0))
    table = sps.poisson.cdf(np.arange(kmax + 1), mu)
    table[-1] = 1.0
    return table


def _binom_cdf_table(n, p):
    import scipy.stats as sps

    table = sps.binom.cdf(np.arange(int(n) + 1), int(n), float(p))
    table[-1] = 1.0
    return table


def _nbinom_cdf_table(n, p):
    import scipy.stats as sps

    mean = n * (1 - p) / p
    var = n * (1 - p) / p**2
    kmax = int(np.ceil(mean + 12 * np.sqrt(var + 1) + 30))
    table = sps.nbinom.cdf(np.arange(kmax + 1), n, p)
    table[-1] = 1.0
    return table


_STATIC_TABLE_BUILDERS = {
    "poisson": lambda mu, loc=0: (_poisson_cdf_table(float(mu)), loc),
    "binom": lambda n, p, loc=0: (_binom_cdf_table(n, p), loc),
    "nbinom": lambda n, p, loc=0: (_nbinom_cdf_table(n, p), loc),
}

# The generic table's cap: far beyond the support of any realistic
# hypergeom, zipf or logser that float32 uniforms can reach.
_GENERIC_TABLE_CAP = 4096


def _generic_discrete_table(name, args, kwargs):
    """(float64 CDF table, support start) for a scipy discrete family
    without a registered function, at numeric parameters, or None.

    The table spans the eps .. 1 - eps quantiles, where eps is one ulp
    below the clamp the engine's uniforms can reach (2^-25 in float32,
    2^-54 in float64; a float64 run whose tails need more than the cap
    goes to the host callback instead of truncating).  A support
    unbounded below (skellam, dlaplace) starts at the eps quantile.
    None for a continuous or unknown family, one with its own function,
    or a table over the cap.
    """
    import scipy.stats as sps

    if lookup(name) is not None:
        return None
    dist = getattr(sps, name, None)
    if dist is None or not isinstance(dist, sps.rv_discrete):
        return None
    eps = 2.0**-25 if config.float_dtype() == torch.float32 else 2.0**-54
    try:
        frozen = dist(*args, **kwargs)
        lo, hi_support = frozen.support()
        if not np.isfinite(lo):
            lo = frozen.ppf(eps)
            if not np.isfinite(lo):
                return None
        hi = frozen.ppf(1.0 - eps)
        if not np.isfinite(hi):
            hi = hi_support
        if not np.isfinite(hi) or hi - lo + 1 > _GENERIC_TABLE_CAP:
            return None
        ks = np.arange(int(lo), int(hi) + 1)
        table = np.asarray(frozen.cdf(ks), np.float64)
        table[-1] = 1.0
        return table, int(lo)
    except (TypeError, ValueError):
        return None


def static_cdf_table(distr, *args, **kwargs):
    """(float64 CDF table, offset) for a discrete family at numeric scalar
    parameters, or None: ``poisson``, ``binom`` and ``nbinom`` from their
    own builders, any other scipy discrete family from the generic scan.

    Array parameters mean a batch of distributions (one table would be
    wrong), except for ``poisson_binom``, whose vector of success
    probabilities parametrises one scalar law.
    """
    params = list(args) + list(kwargs.values())
    if not _is_static(*params):
        return None
    if any(np.ndim(p) != 0 for p in params) and distr != "poisson_binom":
        return None
    builder = _STATIC_TABLE_BUILDERS.get(distr)
    if builder is not None:
        try:
            return builder(*args, **kwargs)
        except TypeError:
            return None
    return _generic_discrete_table(distr, args, kwargs)


@register("poisson")
def poisson(q, mu, loc=0):
    if _is_static(mu) and np.ndim(mu) == 0:
        return _table_ppf(q, _poisson_cdf_table(float(mu)), loc)
    mu, q = _f(mu), _f(q)
    # P(X <= k) = Q(k + 1, mu), the regularized upper incomplete gamma.
    hi = torch.ceil(mu + 12.0 * torch.sqrt(mu + 1.0) + 30.0)
    k = special.discrete_ppf_bisect(lambda k: special.gammaincc(k + 1.0, mu), q, hi)
    return torch.clamp(k, min=0.0) + _f(loc)


@register("binom")
def binom(q, n, p, loc=0):
    if _is_static(n, p) and np.ndim(n) == 0 and np.ndim(p) == 0:
        return _table_ppf(q, _binom_cdf_table(n, p), loc)
    n, p, q = _f(n), _f(p), _f(q)

    # P(X <= k) = I_{1-p}(n - k, k + 1) for 0 <= k < n, else 1.
    def cdf(k):
        return torch.where(
            k >= n, 1.0, special.betainc(torch.clamp(n - k, min=1e-9), k + 1.0, 1.0 - p)
        )

    k = special.discrete_ppf_bisect(cdf, q, n)
    return torch.minimum(torch.clamp(k, min=0.0), n) + _f(loc)


@register("nbinom")
def nbinom(q, n, p, loc=0):
    if _is_static(n, p) and np.ndim(n) == 0 and np.ndim(p) == 0:
        return _table_ppf(q, _nbinom_cdf_table(n, p), loc)
    n, p, q = _f(n), _f(p), _f(q)
    # P(X <= k) = I_p(n, k + 1).
    mean = n * (1.0 - p) / p
    var = n * (1.0 - p) / (p * p)
    hi = torch.ceil(mean + 12.0 * torch.sqrt(var + 1.0) + 30.0)
    k = special.discrete_ppf_bisect(lambda k: special.betainc(n, k + 1.0, p), q, hi)
    return torch.clamp(k, min=0.0) + _f(loc)


# ---------------------------------------------------------------------
# Continuous families without a function: PCHIP quantile tables
# ---------------------------------------------------------------------

# Families whose scipy ppf integrates numerically get coarser grids; the
# PCHIP error (h^4) stays below those ppfs' own noise at these counts.
_PCHIP_KNOTS = {"levy_stable": 257, "studentized_range": 129}
_PCHIP_KNOTS_DEFAULT = 1025
_PCHIP_CACHE = {}


def _pchip_build(name, args, kwargs):
    """The host-built quantile table of a continuous family at numeric
    parameters: ``(coefficients (nseg, 4), z0, h, m, s)``, or None.

    scipy's ppf on a uniform grid in the normal score z (q = ndtr(z), z in
    [-8.3, 8.3], one ulp past the engine's float64 clamp), isotonised,
    centred and scaled at the true quartiles (z = +-0.6745), compressed
    through asinh, and fitted by a monotone cubic (PCHIP) in float64.
    """
    import scipy.special as ssp
    import scipy.stats as sps
    from scipy.interpolate import PchipInterpolator

    dist = getattr(sps, name, None)
    if dist is None or not isinstance(dist, sps.rv_continuous):
        return None
    n_knots = _PCHIP_KNOTS.get(name, _PCHIP_KNOTS_DEFAULT)
    z = np.linspace(-8.3, 8.3, n_knots)
    qs = ssp.ndtr(z)
    try:
        frozen = dist(*args, **kwargs)
        x = np.empty(n_knots, np.float64)
        # In chunks: some ppfs raise at extreme quantiles, and only the
        # chunk that fails pays a retry per point.
        step = 64
        with np.errstate(all="ignore"):
            for i in range(0, n_knots, step):
                sl = slice(i, min(i + step, n_knots))
                try:
                    x[sl] = frozen.ppf(qs[sl])
                except Exception:
                    for j in range(sl.start, sl.stop):
                        try:
                            x[j] = frozen.ppf(qs[j])
                        except Exception:
                            x[j] = np.nan
    except (TypeError, ValueError):
        return None
    finite = np.isfinite(x)
    if not finite.any():
        return None
    i0 = int(np.argmax(finite))
    i1 = n_knots - 1 - int(np.argmax(finite[::-1]))
    z, x = z[i0 : i1 + 1], x[i0 : i1 + 1]
    if len(z) < 16 or not np.isfinite(x).all():
        return None
    x = np.maximum.accumulate(x)  # numeric ppfs can step back by their noise
    m = float(np.interp(0.0, z, x))
    s = float(np.interp(0.6745, z, x) - np.interp(-0.6745, z, x)) / 1.349
    if not (s > 0.0):
        s = max(float(x[-1] - x[0]) / 8.0, 1e-300)
    y = np.arcsinh((x - m) / s)
    try:
        pchip = PchipInterpolator(z, y)
    except ValueError:
        return None
    # PPoly.c is (4, nseg), highest power first, local in (z - z_k).
    coeffs = np.ascontiguousarray(pchip.c.T, np.float64)
    h = float(z[1] - z[0])
    return coeffs, float(z[0]), h, m, s


def static_quantile_table(name, *args, **kwargs):
    """The cached PCHIP quantile table of a continuous family without a
    function, at numeric scalar parameters, or None."""
    if lookup(name) is not None:
        return None
    params = list(args) + list(kwargs.values())
    if not _is_static(*params) or any(np.ndim(p) != 0 for p in params):
        return None
    key = (
        name,
        tuple(float(p) for p in args),
        tuple(sorted((k, float(v)) for k, v in kwargs.items())),
    )
    if key not in _PCHIP_CACHE:
        _PCHIP_CACHE[key] = _pchip_build(name, args, kwargs)
    return _PCHIP_CACHE[key]


def _pchip_ppf(q, table):
    """A PCHIP quantile table at ``q``: z = ndtri(q), the segment's index
    by a floor (the z grid is uniform), a gather of its four coefficients,
    Horner, then x = m + s sinh(y) through ``expm1_safe`` (relative
    accuracy for |y| << 1, where heavy-tailed bodies live)."""
    coeffs, z0, h, m, s = table
    q = _f(q)
    c = torch.from_numpy(np.asarray(coeffs, config.np_float_dtype())).to(q.device)
    nseg = c.shape[0]
    z = torch.clamp(special.ndtri_fast_wide(q), z0, z0 + h * nseg)
    u = (z - z0) / h
    k = torch.clamp(u.to(torch.int32), 0, nseg - 1)
    dz = z - (z0 + k.to(q.dtype) * h)
    ck = c[k.long()]
    y = ((ck[..., 0] * dz + ck[..., 1]) * dz + ck[..., 2]) * dz + ck[..., 3]
    t = special.expm1_safe(y)
    return m + (0.5 * s) * (t + t / (t + 1.0))


# ---------------------------------------------------------------------
# The host callback: scipy.stats for everything else
# ---------------------------------------------------------------------


def is_multivariate(name):
    """True if scipy.stats ``name`` is a multivariate distribution (no ppf)."""
    import scipy.stats as sps

    return not hasattr(getattr(sps, name), "ppf")


def scipy_fallback_ppf(name, q, *args, **kwargs):
    """scipy.stats' ppf on the host, for a family with no function here
    whose parameters are tensors, or whose table does not fit.

    Tensor parameters and ``q`` go to the host as numpy arrays; scipy
    computes in float64; the result comes back on ``q``'s device in the
    float dtype.  Right, and a round trip to the host on every call: no
    path of the CUDA megakernel reaches it.
    """
    import scipy.stats as sps

    dist = getattr(sps, name)  # an unknown name raises here

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    q = _f(q)
    frozen = dist(*(host(a) for a in args), **{k: host(v) for k, v in kwargs.items()})
    out = frozen.ppf(q.detach().cpu().numpy().astype(np.float64))
    return torch.from_numpy(np.asarray(out, config.np_float_dtype())).to(q.device)


def scipy_fallback_rvs(name, q, shape, *args, **kwargs):
    """A multivariate family without a sampler of its own: scipy's ``rvs``
    on the host, seeded with ``int(q[0] * 2**20)`` (one read of the
    column's first value), reshaped to ``shape`` and returned on ``q``'s
    device in the float dtype."""
    import scipy.stats as sps

    seed = int(float(q.reshape(-1)[0]) * 2**20)
    frozen = getattr(sps, name)(*args, **kwargs)
    draws = frozen.rvs(size=shape[0], random_state=seed)
    out = np.asarray(draws, config.np_float_dtype()).reshape(shape)
    return torch.from_numpy(out).to(q.device)


# Normal-score shortcuts: families whose ppf is an elementwise function
# of ndtri(q) have a closed form in a standard-normal score y,
# ppf(ndtr(y)) = g(y).  The correlated paths produce such scores, so g(y)
# skips the ndtr/ndtri roundtrip (exact where the roundtrip drifts in the
# tails).


def _score_norm(y, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * _f(y)


def _score_lognorm(y, s, loc=0.0, scale=1.0):
    return _f(loc) + _f(scale) * torch.exp(_f(s) * _f(y))


_SCORE_KERNELS = {"norm": _score_norm, "lognorm": _score_lognorm}


def score_call(name, y, *args, **kwargs):
    """``ppf(name, ndtr(y))`` in closed form, or None if unsupported."""
    kernel = _SCORE_KERNELS.get(name)
    return None if kernel is None else kernel(y, *args, **kwargs)


def score_emit(var, y, ctx):
    """Score shortcut for a ``Distribution`` node, or None.

    Node-valued parameters resolve through ``ctx`` exactly as in
    ``Distribution._emit``.
    """
    from probabilit_tpu_torch.models.distributions import Distribution
    from probabilit_tpu_torch.models.graph import Node

    if not isinstance(var, Distribution) or var.distr not in _SCORE_KERNELS:
        return None

    def unpack(a):
        return ctx.value(a) if isinstance(a, Node) else a

    args = tuple(unpack(a) for a in var.args)
    kwargs = {k: unpack(v) for k, v in var.kwargs.items()}
    return score_call(var.distr, y, *args, **kwargs)
