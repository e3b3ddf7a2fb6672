"""K1's closed-form family branches in PyTorch: what ``csrc/fast_math.cuh``
and the rewritten bodies of ``csrc/ppf_ops.cuh`` compute per lane.

Each function transcribes its device function on float32 tensors with the
same range reductions, polynomial coefficients, selects and operation
order; ``torch.log2``, ``torch.exp2``, ``1 / x`` and ``torch.sqrt`` stand
in for the MUFU approximations (``lg2.approx``, ``ex2.approx``,
``rcp.approx``, ``sqrt.approx``), and where the kernel's result rests on
an FMA's exact residual (``div_fast``) a float64 product stands in for
the FMA.  geom keeps libm's ``log1pf`` in the kernel, for
which ``torch.log1p`` stands in (it is that function on the card).  ``FAMILIES`` maps each closed-form family whose
body was rewritten onto its standard variate ``x(q, *shapes)``; the tape's
``AFFINE`` row gives ``loc + scale * x`` (``value``).

``mufu_error(sign)`` shifts every MUFU stand-in by its documented error
bound (``lg2.approx``: 2^-22 absolute on [0.5, 2], 2 ulps elsewhere;
``ex2.approx``: 2 ulps; ``rcp.approx``: 1 ulp; ``sqrt.approx``: 2 ulps),
all in the direction ``sign``, so the CPU tests can hold the families to
the twin tolerance with the hardware's errors in place.

The CPU tests hold these to ``ops/ppf.py`` and to the JAX package;
``chip_smoke.py`` holds the kernel to them on the card.  Nothing on the
sampling path calls this module.
"""

from __future__ import annotations

import contextlib
import math

import torch

from probabilit_tpu_torch.ops import special as _special

__all__ = [
    "FAMILIES",
    "mufu_error",
    "lg2_approx",
    "ex2_approx",
    "rcp_approx",
    "sqrt_approx",
    "div_fast",
    "rcp_fast",
    "log_fast",
    "log1p_fast",
    "log_mufu",
    "exp_fast",
    "expm1_fast",
    "pow_fast",
    "tan_fast",
    "cot_fast",
    "tan_or_cot",
    "sin_fast",
    "ndtr_mufu",
    "ndtri_wide_fast",
    "div_rounded",
    "value",
]

F32 = torch.float32
LN2 = 0.6931472
LN2_HI = 0.69314575
LN2_LO = 1.4286068e-06
LOG2E = 1.442695
QUARTER_PI = 0.7853982
HALF_PI_HI = 1.5707964
HALF_PI_LO = -4.371139e-08
PI = 3.141592653589793
HALF_PI = 1.5707963267948966
SQRT2PI = 2.5066282746310002
INV_SQRT2PI = 0.3989422804014327
FLT_MIN = 1.1754943508222875e-38

_ERROR = 0.0  # the sign of the MUFU error model, 0 for exact stand-ins


@contextlib.contextmanager
def mufu_error(sign):
    """Within the block every MUFU stand-in errs by its bound, in the
    direction ``sign`` (+1 or -1)."""
    global _ERROR
    previous, _ERROR = _ERROR, float(sign)
    try:
        yield
    finally:
        _ERROR = previous


def _t(x, like=None):
    """x as float32, a number broadcast like the tensor ``like``."""
    if isinstance(x, torch.Tensor):
        return x.to(F32)
    return torch.tensor(x, dtype=F32) if like is None else torch.full_like(like, x, dtype=F32)


def _ulp(x):
    """The float32 spacing at |x| (at least the smallest normal's)."""
    ax = torch.abs(x).clamp(min=FLT_MIN)
    gap = torch.nextafter(ax, torch.full_like(ax, math.inf)) - ax
    return torch.where(torch.isfinite(x), gap, torch.zeros_like(gap))


def _fma(a, b, c):
    """a * b + c rounded once (float64 holds the float32 product exactly)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _horner(x, coefs):
    """Horner's rule from the highest coefficient, one FMA a step."""
    p = torch.full_like(x, coefs[0])
    for c in coefs[1:]:
        p = _fma(p, x, torch.full_like(x, c))
    return p


# ---- The hardware's approximations ---------------------------------------


def lg2_approx(x):
    """lg2.approx.ftz: a denormal x is 0, its log2 -inf."""
    x = _t(x)
    x = torch.where(torch.abs(x) < FLT_MIN, torch.zeros_like(x), x)
    return lg2_full(x)


def lg2_full(x):
    x = _t(x)
    r = torch.log2(x)
    if _ERROR:
        near = (x >= 0.5) & (x <= 2.0)
        r = r + _ERROR * torch.where(near, torch.full_like(r, 2.0**-22), 2.0 * _ulp(r))
    return r


def ex2_approx(t):
    """ex2.approx.ftz: a result below 2^-126 is 0."""
    r = torch.exp2(_t(t))
    r = torch.where(r < FLT_MIN, torch.zeros_like(r), r)
    return r + _ERROR * 2.0 * _ulp(r) if _ERROR else r


def rcp_approx(x):
    r = 1.0 / _t(x)
    return r + _ERROR * _ulp(r) if _ERROR else r


def sqrt_approx(x):
    r = torch.sqrt(_t(x))
    return r + _ERROR * 2.0 * _ulp(r) if _ERROR else r


def div_fast(a, b):
    b = _t(b)
    a = _t(a, b)
    r = rcp_approx(b)
    q = a * r
    return _fma(_fma(-b, q, a), r, q)


def rcp_fast(b):
    return div_fast(1.0, b)


# ---- Logarithms -----------------------------------------------------------

_LOG1P = (-0.12949032, 0.14004828, -0.1216714, 0.14001147, -0.16682306, 0.20010749,
          -0.24999717, 0.3333321, -0.5)


def _log1p_reduced(f):
    return _fma(f * f, _horner(f, _LOG1P), f)


def _reduce_log(x):
    """(e, m) with x = 2^e m, m in [2/3, 4/3), for positive normal x."""
    ix = x.view(torch.int32)
    e = (ix - 0x3F2AAAAB) >> 23
    return e, (ix - (e << 23)).view(F32)


def _log_from(e, f):
    fe = e.to(F32)
    return _fma(fe, torch.full_like(fe, LN2_HI),
                _fma(fe, torch.full_like(fe, LN2_LO), _log1p_reduced(f)))


def _positive_normal(x):
    ix = x.view(torch.int32)
    return (ix >= 0x00800000) & (ix <= 0x7F7FFFFF)


def log_fast(x):
    x = _t(x)
    e, m = _reduce_log(x)
    return torch.where(_positive_normal(x), _log_from(e, m - 1.0), lg2_full(x) * LN2)


def log1p_fast(x):
    x = _t(x)
    u = 1.0 + x
    e, m = _reduce_log(u)
    scale = (0x3F800000 - (e << 23)).view(F32)  # 2^-e
    r = _log_from(e, _fma(x - (u - 1.0), scale, m - 1.0))
    return torch.where(_positive_normal(u), r, lg2_full(u) * LN2)


def log_mufu(x):
    return lg2_approx(x) * LN2


# ---- Exponentials and powers ----------------------------------------------


def exp_fast(x):
    return ex2_approx(_t(x) * LOG2E)


def expm1_fast(x):
    x = _t(x)
    taylor = x * (1.0 + x * (0.5 + x * (1.0 / 6.0 + x * (1.0 / 24.0 + x * (
        1.0 / 120.0 + x * (1.0 / 720.0 + x * 1.984126984126984e-4))))))
    return torch.where(torch.abs(x) < 0.25, taylor, exp_fast(x) - 1.0)


def pow_fast(x, y):
    x = _t(x)
    x, y = torch.broadcast_tensors(x, _t(y, x))
    return ex2_approx(y * lg2_approx(x))


# ---- Trigonometric functions ----------------------------------------------

_TAN = (0.009385742, 0.0031193472, 0.024430493, 0.053411182, 0.13338801, 0.33333156)
_SIN = (2.60578e-06, -0.00019809602, 0.0083330665, -0.1666666)


def _tan_reduced(r):
    z = r * r
    return _fma(r * z, _horner(z, _TAN), r)


def tan_or_cot(x, cot):
    """tan x where ``cot`` is False, 1 / tan x where it is True (a bool or
    a bool tensor), for |x| up to the float nearest pi/2."""
    x = _t(x)
    cot = torch.as_tensor(cot, dtype=torch.bool, device=x.device).expand_as(x)
    ax = torch.abs(x)
    far = ax > QUARTER_PI
    d = (HALF_PI_HI - ax) + HALF_PI_LO
    t = _tan_reduced(torch.where(far, d, ax))
    v = torch.where(far != cot, rcp_fast(t), t)
    return torch.where(x < 0.0, -v, v)


def tan_fast(x):
    return tan_or_cot(x, False)


def cot_fast(x):
    return tan_or_cot(x, True)


def sin_fast(x):
    x = _t(x)
    z = x * x
    return _fma(x * z, _horner(z, _SIN), x)


# ---- The normal distribution ----------------------------------------------


def ndtr_mufu(x):
    x = _t(x)
    z = torch.abs(x) * 0.70710678118654752
    t = rcp_approx(1.0 + 0.3275911 * z)  # __fdividef(1, .)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    tail = 0.5 * poly * exp_fast(-z * z)
    return torch.where(x >= 0.0, 1.0 - tail, tail)


def ndtri_wide_fast(q):
    q = _t(q)
    tail = torch.clamp(torch.minimum(q, 1.0 - q), min=1e-37)
    w = -_fma(lg2_approx(tail * (1.0 - tail)), torch.full_like(q, LN2),
              torch.full_like(q, 1.3862944))
    p1 = _horner(w - 2.5, _GILES_CENTRAL)
    p2 = _horner(sqrt_approx(torch.clamp(w, max=16.64)) - 3.0, _GILES_TAIL)
    erfinv = torch.where(w < 5.0, p1, p2) * (2.0 * q - 1.0)
    y = sqrt_approx(w)
    for _ in range(3):
        inv2 = rcp_approx(2.0 * y * y)
        series = log_mufu(1.0 + (-inv2 + 3.0 * inv2 * inv2))
        y = sqrt_approx(torch.clamp(w + 0.6931472 - 0.5723649 - log_mufu(y) + series, min=1.0))
    far = torch.where(q >= 0.5, y, -y)
    return 1.4142135623730951 * torch.where(w > 16.3, far, erfinv)


# sampling_math.cuh's giles_central (in w - 2.5) and giles_tail (in sqrt(w) - 3).
_GILES_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_GILES_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# ---- IEEE division without its slow path -----------------------------------


def div_rounded(a, b):
    return (_t(a).double() / _t(b).double()).to(F32)


# ---- The rewritten family bodies: standard variates -----------------------


def _select(cond, a, b):
    return torch.where(cond, a, b)


def expon(q):
    return -log1p_fast(-q)


def lognorm(q, s):
    return exp_fast(s * _special.ndtri_fast(q))


def truncnorm(q, a, b):
    upper = (a + b > 0.0).expand_as(q)
    lo = _select(upper, ndtr_mufu(-a), ndtr_mufu(a))
    hi = _select(upper, ndtr_mufu(-b), ndtr_mufu(b))
    z = ndtri_wide_fast(lo + q * (hi - lo))
    return torch.minimum(torch.maximum(_select(upper, -z, z), a), b)


def cauchy(q):
    return tan_fast(PI * (q - 0.5))


def laplace(q):
    low = q < 0.5
    v = log_mufu(_select(low, 2.0 * q, 2.0 * (1.0 - q)))
    return _select(low, v, -v)


def logistic(q):
    return log_mufu(q) - log_mufu(1.0 - q)


def gumbel_r(q):
    return -log_mufu(-log_fast(q))


def gumbel_l(q):
    return log_mufu(-log1p_fast(-q))


def rayleigh(q):
    return sqrt_approx(-2.0 * log1p_fast(-q))


def halfnorm(q):
    return -ndtri_wide_fast(0.5 * (1.0 - q))


def pareto(q, b):
    return pow_fast(1.0 - q, div_fast(-1.0, b))


def weibull_min(q, c):
    return pow_fast(-log1p_fast(-q), rcp_fast(c))


def weibull_max(q, c):
    return -pow_fast(-log_fast(q), rcp_fast(c))


def powerlaw(q, a):
    return pow_fast(q, rcp_fast(a))


def loguniform(q, a, b):
    la = log_fast(a)
    return exp_fast(la + q * (log_fast(b) - la))


def arcsine(q):
    s = sin_fast(HALF_PI * q)
    return s * s


def hypsecant(q):
    mag = log_mufu(tan_fast(HALF_PI * torch.minimum(q, 1.0 - q)))
    return _select(q < 0.5, mag, -mag)


def fisk(q, c):
    return pow_fast(div_fast(q, 1.0 - q), rcp_fast(c))


def genpareto(q, c):
    l = log1p_fast(-q)
    return _select(torch.abs(c) < 1e-9, -l, expm1_fast(-c * l) * rcp_fast(c))


def genextreme(q, c):
    ll = log_mufu(-log_fast(q))
    return _select(torch.abs(c) < 1e-9, -ll, -(expm1_fast(c * ll) * rcp_fast(c)))


def alpha(q, a):
    na = ndtr_mufu(a)
    D = na * (1.0 - q) * rcp_fast(INV_SQRT2PI * exp_fast(-0.5 * a * a))
    tail = rcp_fast(D * (1.0 - 0.5 * a * D))
    body = rcp_fast(a - ndtri_wide_fast(q * na))
    return _select(q > 0.999, tail, body)


def bradford(q, c):
    return expm1_fast(q * log1p_fast(c)) * rcp_fast(c)


def burr(q, c, d):
    t = expm1_fast(-log_fast(q) * rcp_fast(d))
    return pow_fast(t, div_fast(-1.0, c))


def burr12(q, c, d):
    t = expm1_fast(-log1p_fast(-q) * rcp_fast(d))
    return pow_fast(t, rcp_fast(c))


def dweibull(q, c):
    low = q < 0.5
    t = torch.clamp(_select(low, 2.0 * q, 2.0 * (1.0 - q)), min=1e-12)
    mag = pow_fast(-log_fast(t), rcp_fast(c))
    return _select(low, -mag, mag)


def exponpow(q, b):
    return pow_fast(log1p_fast(-log1p_fast(-q)), rcp_fast(b))


def exponweib(q, a, c):
    t = -expm1_fast(log_fast(q) * rcp_fast(a))
    return pow_fast(-log_fast(t), rcp_fast(c))


def fatiguelife(q, c):
    t = c * _special.ndtri_fast(q)
    r = t + sqrt_approx(t * t + 4.0)
    return 0.25 * (r * r)


def genhalflogistic(q, c):
    t = div_fast(1.0 - q, 1.0 + q)
    return (1.0 - pow_fast(t, c)) * rcp_fast(c)


def genlogistic(q, c):
    return -log_mufu(expm1_fast(-log_fast(q) * rcp_fast(c)))


def gibrat(q):
    return exp_fast(_special.ndtri_fast(q))


def gompertz(q, c):
    return log1p_fast(-log1p_fast(-q) * rcp_fast(c))


def halfcauchy(q):
    return cot_fast(HALF_PI * (1.0 - q))


def halflogistic(q):
    return log1p_fast(div_fast(2.0 * q, 1.0 - q))


def invweibull(q, c):
    return pow_fast(-log_fast(q), div_fast(-1.0, c))


def johnsonsb(q, a, b):
    z = (_special.ndtri_fast(q) - a) * rcp_fast(b)
    return rcp_fast(1.0 + exp_fast(-z))


def johnsonsu(q, a, b):
    ez = exp_fast((_special.ndtri_fast(q) - a) * rcp_fast(b))
    return 0.5 * (ez - rcp_fast(ez))


def kappa3(q, a):
    z = a * log_fast(q)
    ratio = div_fast(exp_fast(z), -expm1_fast(z))
    return pow_fast(a * ratio, rcp_fast(a))


def laplace_asymmetric(q, kappa):
    k2 = kappa * kappa
    low = q < div_fast(k2, 1.0 + k2)
    t = _select(low, q * (1.0 + k2) * rcp_fast(k2), (1.0 - q) * (1.0 + k2))
    v = log_mufu(torch.clamp(t, min=1e-30))
    return _select(low, kappa * v, -v * rcp_fast(kappa))


def levy(q):
    z = ndtri_wide_fast(0.5 * q)
    return rcp_fast(z * z)


def levy_l(q):
    z = ndtri_wide_fast(0.5 * (1.0 - q))
    return -rcp_fast(z * z)


def loglaplace(q, c):
    low = q < 0.5
    t = torch.clamp(_select(low, 2.0 * q, 2.0 * (1.0 - q)), min=1e-30)
    return pow_fast(t, _select(low, rcp_fast(c), div_fast(-1.0, c)))


def lomax(q, c):
    return expm1_fast(-log1p_fast(-q) * rcp_fast(c))


def mielke(q, k, s):
    z = div_fast(s, k) * log_fast(q)
    ratio = div_fast(exp_fast(z), -expm1_fast(z))
    return pow_fast(ratio, rcp_fast(s))


def moyal(q):
    return -2.0 * log_mufu(-ndtri_wide_fast(0.5 * q))


def _powernorm_score(q, c):
    low = q < 0.5
    one_minus_w = -expm1_fast(log1p_fast(-q) * rcp_fast(c))
    w = pow_fast(1.0 - q, rcp_fast(c))
    z = ndtri_wide_fast(_select(low, torch.clamp(one_minus_w, min=FLT_MIN), w))
    return _select(low, -z, z)


def powerlognorm(q, c, s):
    return exp_fast(-s * _powernorm_score(q, c))


def powernorm(q, c):
    return -_powernorm_score(q, c)


def trapezoid(q, c, d):
    h = div_fast(2.0, 1.0 + d - c)
    rh = rcp_fast(h)
    rise = sqrt_approx(torch.clamp(2.0 * c * q * rh, min=0.0))
    flat = q * rh + 0.5 * c
    fall = 1.0 - sqrt_approx(torch.clamp(2.0 * (1.0 - d) * (1.0 - q) * rh, min=0.0))
    return _select(q < 0.5 * h * c, rise, _select(q < h * (d - 0.5 * c), flat, fall))


def truncexpon(q, b):
    return -log1p_fast(q * expm1_fast(-b))


def truncpareto(q, b, c):
    return pow_fast(1.0 - q * (1.0 - pow_fast(c, -b)), div_fast(-1.0, b))


def truncweibull_min(q, c, a, b):
    sa = exp_fast(-pow_fast(a, c))
    sb = exp_fast(-pow_fast(b, c))
    return pow_fast(-log_fast(sa - q * (sa - sb)), rcp_fast(c))


def tukeylambda(q, lam):
    general = (pow_fast(q, lam) - pow_fast(1.0 - q, lam)) * rcp_fast(lam)
    return _select(torch.abs(lam) < 1e-7, log_mufu(q) - log_mufu(1.0 - q), general)


def skewcauchy(q, a):
    wl, wu = 1.0 - a, 1.0 + a
    f0 = 0.5 * wl
    lower = q < f0
    tail = _select(lower, q < 0.5 * f0, q > f0 + 0.5 * wu * 0.5)
    w = _select(lower, wl, wu)
    arg = _select(tail, _select(lower, q, 1.0 - q), q - f0)
    t = tan_or_cot(PI * arg * _select(lower, rcp_fast(wl), rcp_fast(wu)), tail)
    return w * _select(tail & lower, -t, t)


def kappa4(q, h, k):
    logq = log_fast(q)
    t = _select(h == 0.0, -logq, -(expm1_fast(h * logq) * rcp_fast(h)))
    logt = log_mufu(t)
    return _select(k == 0.0, -logt, -(expm1_fast(k * logt) * rcp_fast(k)))


def crystalball(q, beta, m):
    b2h = 0.5 * beta * beta
    C = div_fast(m, beta * (m - 1.0)) * exp_fast(-b2h)
    D = SQRT2PI * ndtr_mufu(beta)
    logN = -log_fast(C + D)
    L = (log_mufu(q) + log_fast(m - 1.0) - logN - m * log_fast(div_fast(m, beta)) + b2h) \
        * rcp_fast(1.0 - m)
    x_pow = div_fast(m, beta) - beta - exp_fast(L)
    tail = q < exp_fast(logN) * C
    core = torch.clamp((1.0 - q) * (C + D) * INV_SQRT2PI, FLT_MIN, 1.0)
    x_gauss = -ndtri_wide_fast(_select(tail, torch.full_like(q, 0.5), core))
    return _select(tail, x_pow, x_gauss)


def geom(q, p):
    # libm's log1pf stays in the kernel (ppf_ops.cuh): torch.log1p is it on the card.
    return torch.clamp(torch.ceil(div_rounded(torch.log1p(-q), torch.log1p(-p))), min=1.0)


FAMILIES = {
    fn.__name__: fn
    for fn in (
        expon, lognorm, truncnorm, cauchy, laplace, logistic, gumbel_r, gumbel_l, rayleigh,
        halfnorm, pareto, weibull_min, weibull_max, powerlaw, loguniform, arcsine, hypsecant,
        fisk, genpareto, genextreme, geom, alpha, bradford, burr, burr12, dweibull, exponpow,
        exponweib, fatiguelife, genhalflogistic, genlogistic, gibrat, gompertz, halfcauchy,
        halflogistic, invweibull, johnsonsb, johnsonsu, kappa3, laplace_asymmetric, levy,
        levy_l, loglaplace, lomax, mielke, moyal, powerlognorm, powernorm, trapezoid,
        truncexpon, truncpareto, truncweibull_min, tukeylambda, skewcauchy, kappa4,
        crystalball,
    )
}
FAMILIES["reciprocal"] = loguniform


def value(family, q, args=(), kwargs=None):
    """The kernel's value of a rewritten ``family`` node on the float32
    quantiles ``q``: its standard variate at the shapes ``args`` (numbers),
    then the tape's next row, ``loc + scale * x`` (geom, discrete:
    ``x + loc``)."""
    kwargs = kwargs or {}
    q = _t(q)
    x = FAMILIES[family](q, *(_t(a, q) for a in args))
    loc = _t(kwargs.get("loc", 0.0))
    if family == "geom":
        return x + loc
    return loc + _t(kwargs.get("scale", 1.0)) * x
