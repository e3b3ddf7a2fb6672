"""Special functions for the inverse-CDF sampling path.

Port of ``probabilit_tpu/ops/special.py``: the Giles (2012)
single-precision inverse error function, the fast standard-normal
quantile built on it (and its wide-range form for derived quantiles),
the Abramowitz & Stegun 7.1.26 normal CDF and its survival and scaled
forms, ``expm1_safe``, and the incomplete gamma and beta functions with
their safeguarded-Newton inverses (``gammaincinv``, ``betaincinv``), the
generic ``continuous_ppf_newton`` and the discrete
``discrete_ppf_bisect``; and for the copulas the Student-t CDF ``t_cdf``
and the chi-square draws ``chi2_draws``.  The device kernels
(``csrc/sampling_math.cuh``, ``csrc/special_ops.cuh``) transcribe the
same coefficients, so the plain and kernel paths compute the same
functions.

``kernel_safe_special`` switches the incomplete functions to what the
megakernel computes (Lanczos ``lgamma_kernel``, series/continued-fraction
``gammainc_kernel``, the 40-pair ``betainc_kernel``, ``ndtri_fast_wide``
in the Newton guesses), as the JAX package's switch does for its TPU
kernel.  Outside it, the plain path takes ``torch.special.gammainc`` and
``gammaln`` where the JAX package takes ``jax.scipy.special``'s, and
``betainc`` below (PyTorch has none) where it takes JAX's.
"""

from __future__ import annotations

import torch

__all__ = [
    "erfinv_f32",
    "ndtri_fast",
    "ndtri_fast_wide",
    "ndtr_fast",
    "ndtr_neg_fast",
    "ndtr_scaled_neg",
    "expm1_safe",
    "kernel_safe_special",
    "lgamma_kernel",
    "gammainc_kernel",
    "betainc_kernel",
    "betainc",
    "elementwise",
    "pow",
    "gammaincc",
    "discrete_ppf_bisect",
    "gammaincinv",
    "gammainccinv",
    "betaincinv",
    "continuous_ppf_newton",
    "t_cdf",
    "chi2_draws",
]


def erfinv_f32(x):
    """Fast single-precision inverse error function (Giles 2012 scheme).

    Two short polynomial branches in w = -log(1-x^2).  w is clamped at
    16.64, the end of the tail branch's fit, so inputs that round to
    exactly +/-1 saturate at ~+/-4 with the correct sign.
    """
    x = x.to(torch.float32)
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-37))
    w = torch.clamp(w, max=16.64)
    p1, p2 = _giles_branch_polys(w)
    return torch.where(w < 5.0, p1, p2) * x


def _giles_branch_polys(w):
    """Giles (2012) erfinv polynomial branches evaluated at ``w``.

    Returns ``(p1, p2)``: the central branch (fit for w < 5) in
    ``w - 2.5`` and the tail branch in ``sqrt(w) - 3``.
    """
    wc = w - 2.5
    p1 = torch.full_like(w, 2.81022636e-08)
    p1 = 3.43273939e-07 + p1 * wc
    p1 = -3.5233877e-06 + p1 * wc
    p1 = -4.39150654e-06 + p1 * wc
    p1 = 0.00021858087 + p1 * wc
    p1 = -0.00125372503 + p1 * wc
    p1 = -0.00417768164 + p1 * wc
    p1 = 0.246640727 + p1 * wc
    p1 = 1.50140941 + p1 * wc

    ws = torch.sqrt(torch.clamp(w, max=16.64)) - 3.0
    p2 = torch.full_like(w, -0.000200214257)
    p2 = 0.000100950558 + p2 * ws
    p2 = 0.00134934322 + p2 * ws
    p2 = -0.00367342844 + p2 * ws
    p2 = 0.00573950773 + p2 * ws
    p2 = -0.0076224613 + p2 * ws
    p2 = 0.00943887047 + p2 * ws
    p2 = 1.00167406 + p2 * ws
    p2 = 2.83297682 + p2 * ws
    return p1, p2


_SQRT2 = 1.4142135623730951


def ndtri_fast(q):
    """Standard-normal quantile: the Giles path in float32, exact in float64.

    Valid for quantiles in [2^-24, 1 - 2^-24], the open-interval range the
    engine's generators produce (``qmc.clamp_open_unit``).
    """
    if q.dtype != torch.float32:
        return torch.special.ndtri(q)
    return _SQRT2 * erfinv_f32(2.0 * q - 1.0)


def ndtri_fast_wide(q):
    """Standard-normal quantile, accurate for q down to 1e-37 (float32).

    The same Giles branches as :func:`erfinv_f32`, but w = -log(4 q (1-q))
    is computed directly from q via log/log1p, so quantiles below ~3e-8
    do not collapse onto x = 2q - 1 = -1.  Beyond the Giles fit (w > 16.3)
    three fixed-point steps of the erfc asymptotic series take over.
    Exactly-0/1 inputs saturate at about +/-13 with the correct sign.
    """
    if q.dtype != torch.float32:
        return torch.special.ndtri(q)
    tail = torch.minimum(q, 1.0 - q)
    tail_c = torch.clamp(tail, min=1e-37)
    w = -(torch.log(tail_c) + torch.log1p(-tail_c) + 1.3862944)
    x = 2.0 * q - 1.0
    sign = torch.where(q >= 0.5, 1.0, -1.0).to(torch.float32)
    p1, p2 = _giles_branch_polys(w)

    # Far tail: y^2 = w + ln2 - ln(y sqrt(pi)) + log1p(-1/(2y^2) + 3/(4y^4)).
    y = torch.sqrt(w)
    for _ in range(3):
        inv2 = 1.0 / (2.0 * y * y)
        series = torch.log1p(-inv2 + 3.0 * inv2 * inv2)
        y = torch.sqrt(torch.clamp(w + 0.6931472 - 0.5723649 - torch.log(y) + series, min=1.0))

    erfinv = torch.where(w > 16.3, y * sign, torch.where(w < 5.0, p1 * x, p2 * x))
    return _SQRT2 * erfinv


def ndtr_fast(x):
    """Standard-normal CDF in float32 (Abramowitz & Stegun 7.1.26).

    The lower tail ``0.5 * poly(t) * exp(-z^2)`` is computed directly,
    never as ``1 - (something near 1)``, so it keeps relative accuracy
    for x << 0.  Other dtypes take ``torch.special.ndtr``.
    """
    if x.dtype != torch.float32:
        return torch.special.ndtr(x)
    z = torch.abs(x) * (1.0 / _SQRT2)
    t = 1.0 / (1.0 + 0.3275911 * z)
    tail = 0.5 * _as_tail_poly(t) * torch.exp(-z * z)
    return torch.where(x >= 0, 1.0 - tail, tail)


def _as_tail_poly(t):
    """A&S 7.1.26 erfc polynomial in ``t = 1/(1 + 0.3275911 z)``."""
    return t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )


def ndtr_neg_fast(x):
    """Survival function ndtr(-x) = P(Z > x), relative-accurate for x > 0."""
    return ndtr_fast(-x)


def ndtr_scaled_neg(x):
    """``exp(x^2/2) * ndtr(x)`` for ``x <= 0`` (the scaled normal CDF).

    Products like ``exp(c) * ndtr(x)`` evaluate as
    ``exp(c - x^2/2) * ndtr_scaled_neg(x)`` and stay finite where the two
    factors alone over- or underflow.  In float32 the A&S 7.1.26 tail
    without its exponential, and past |x| = 6 the Mills-ratio series
    (relative-accurate to ~2e-5 where the absolute-accurate polynomial is
    not); other dtypes ``exp(x^2/2 + log_ndtr(x))``.
    """
    if x.dtype != torch.float32:
        return torch.exp(0.5 * x * x + torch.special.log_ndtr(x))
    z = torch.abs(x) * (1.0 / _SQRT2)
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = 0.5 * _as_tail_poly(t)
    x2 = torch.clamp(x * x, min=1.0)
    u = 1.0 / x2
    series = 1.0 + u * (-1.0 + u * (3.0 + u * (-15.0 + 105.0 * u)))
    mills = series / (torch.sqrt(torch.abs(x2)) * 2.5066282746310002)
    return torch.where(torch.abs(x) > 6.0, mills, poly)


def expm1_safe(x):
    """exp(x) - 1, accurate near zero: in float32 a 7-term Taylor branch
    below |x| < 0.25 (what the TPU kernel can lower), else ``torch.expm1``."""
    if x.dtype == torch.float64:
        return torch.expm1(x)
    small = x * (
        1.0
        + x
        * (
            0.5
            + x * (1.0 / 6.0 + x * (1.0 / 24.0 + x * (1.0 / 120.0 + x * (1.0 / 720.0 + x / 5040.0))))
        )
    )
    return torch.where(torch.abs(x) < 0.25, small, torch.exp(x) - 1.0)


_NEWTON_ITERS = 26
_TINY = 1e-30
_IN_KERNEL = False


class kernel_safe_special:
    """Context manager: compute the incomplete functions as the kernel does.

    ``cuda_exec``'s plain twin runs its ppf rows inside it.  The flag is
    read at call time and restored on exit.
    """

    def __enter__(self):
        global _IN_KERNEL
        self._prev = _IN_KERNEL
        _IN_KERNEL = True
        return self

    def __exit__(self, *exc):
        global _IN_KERNEL
        _IN_KERNEL = self._prev
        return False


def _dtype(*xs):
    """The working dtype: float64 if any operand is, else float32."""
    return torch.float64 if any(
        isinstance(x, torch.Tensor) and x.dtype == torch.float64 for x in xs
    ) else torch.float32


def _device(*xs):
    """The device of the first operand that is a tensor off the CPU, else
    the CPU's."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x.device
    return torch.device("cpu")


def _broadcast(*xs):
    dtype, device = _dtype(*xs), _device(*xs)
    return torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=dtype, device=device) for x in xs)
    )


def lgamma_kernel(x):
    """Log-gamma for x > 0 by the Lanczos approximation (g = 7, 9 terms).

    float32 relative error < 1e-6 on (0, 1e4).
    """
    coefs = (
        676.5203681218851,
        -1259.1392167224028,
        771.32342877765313,
        -176.61502916214059,
        12.507343278686905,
        -0.13857109526572012,
        9.9843695780195716e-6,
        1.5056327351493116e-7,
    )
    z = x - 1.0
    acc = torch.full_like(z, 0.99999999999980993)
    for i, c in enumerate(coefs, start=1):
        acc = acc + c / (z + i)
    t = z + 7.5
    return 0.9189385332046727 + (z + 0.5) * torch.log(t) - t + torch.log(acc)


def _gammainc_series(a, x, log_prefactor, iters=48):
    """P(a, x) by its power series (accurate for x < a + 1)."""
    term = total = torch.ones_like(x) / a
    for n in range(iters):
        term = term * x / (a + 1.0 + n)
        total = total + term
    return total * torch.exp(log_prefactor)


def _lentz_guard(v):
    return torch.where(torch.abs(v) < _TINY, _TINY, v)


def _gammainc_cf(a, x, log_prefactor, iters=48):
    """Q(a, x) by Lentz's continued fraction (accurate for x >= a + 1)."""
    b = x + 1.0 - a
    c = torch.full_like(x, 1e30)
    d = 1.0 / _lentz_guard(b)
    h = d
    for i in range(iters):
        i1 = i + 1.0
        an = -i1 * (i1 - a)
        bb = x + 1.0 - a + 2.0 * i1
        d = 1.0 / _lentz_guard(bb + an * d)
        c = _lentz_guard(bb + an / c)
        h = h * d * c
    return torch.exp(log_prefactor) * h


def gammainc_kernel(a, x):
    """Regularized lower incomplete gamma P(a, x), as the kernel computes it.

    Series for x < a + 1, the continued fraction otherwise (both evaluated
    and selected elementwise; the kernel evaluates only the selected one,
    which gives the same value).  Sized for a in (0, ~30].
    """
    a, x = _broadcast(a, x)
    x_safe = torch.clamp(x, min=_TINY)
    log_pre = a * torch.log(x_safe) - x_safe - lgamma_kernel(a)
    p = torch.where(
        x_safe < a + 1.0,
        _gammainc_series(a, x_safe, log_pre),
        1.0 - _gammainc_cf(a, x_safe, log_pre),
    )
    p = torch.where(x <= 0.0, 0.0, p)
    return torch.clamp(p, 0.0, 1.0)


def elementwise(fn, *xs):
    """``fn(*xs)`` broadcast, with no value depending on the batch around it.

    On the CPU, ``torch.special.gammainc`` and ``torch.pow`` round
    differently in their vectorised loop and in their scalar loop, so
    which path an element takes depends on its position and on the length
    of the call.  Strided operands (and at least two elements) send every
    element through the scalar loop.  Other devices call ``fn`` as it is.
    """
    xs = _broadcast(*xs)
    if xs[0].device.type != "cpu":
        return fn(*xs)
    shape = xs[0].shape
    one = torch.ones(1, dtype=xs[0].dtype)

    def strided(v):
        v = torch.cat([v.reshape(-1), one])
        return torch.stack([v, v], dim=-1)[:, 0]

    return fn(*(strided(v) for v in xs))[:-1].reshape(shape)


def pow(x, y):
    """``torch.pow``, batch-independent (``elementwise``)."""
    return elementwise(torch.pow, x, y)


def _gammainc_torch(a, x):
    """``torch.special.gammainc``, batch-independent (``elementwise``)."""
    return elementwise(torch.special.gammainc, a, x)


def gammaincc(a, x):
    """Regularized upper incomplete gamma Q(a, x) for the plain path:
    ``torch.special.gammaincc``, batch-independent (``elementwise``)."""
    return elementwise(torch.special.gammaincc, a, x)


def _betacf(a, b, x, iters=40):
    """Continued fraction of betainc (Lentz, paired even/odd steps)."""
    qab = a + b
    qap = a + 1.0
    qam = a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _lentz_guard(1.0 - qab * x / qap)
    h = d
    for m1 in range(iters):
        m = m1 + 1.0
        two_m = 2.0 * m
        aa = m * (b - m) * x / ((qam + two_m) * (a + two_m))
        d = 1.0 / _lentz_guard(1.0 + aa * d)
        c = _lentz_guard(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + two_m) * (qap + two_m))
        d = 1.0 / _lentz_guard(1.0 + aa * d)
        c = _lentz_guard(1.0 + aa / c)
        h = h * d * c
    return h


def _betainc(a, b, x, log_beta, cf_iters, ceiling):
    """I_x(a, b) with the symmetry split at x = (a+1)/(a+b+2), x clamped
    to [_TINY, ceiling].

    One continued fraction on the operands each lane selects (``(a, b,
    x)`` or ``(b, a, 1 - x)``): elementwise the same arithmetic as
    evaluating both and selecting.
    """
    xc = torch.clamp(x, _TINY, ceiling)
    log_bt = log_beta(a + b) - log_beta(a) - log_beta(b) + a * torch.log(xc) + b * torch.log1p(-xc)
    bt = torch.exp(log_bt)
    direct = xc < (a + 1.0) / (a + b + 2.0)
    pa, pb = torch.where(direct, a, b), torch.where(direct, b, a)
    cf = _betacf(pa, pb, torch.where(direct, xc, 1.0 - xc), iters=cf_iters)
    p = torch.where(direct, bt * cf / a, 1.0 - bt * cf / b)
    p = torch.where(x <= 0.0, 0.0, p)
    p = torch.where(x >= 1.0, 1.0, p)
    return torch.clamp(p, 0.0, 1.0)


def betainc_kernel(a, b, x):
    """Regularized incomplete beta I_x(a, b), as the kernel computes it:
    Lanczos log-gammas and 40 continued-fraction pairs.  Sized for a, b in
    (0, ~30]."""
    a, b, x = _broadcast(a, b, x)
    # The float32 kernel's ceiling, 1 - 1e-7 (K1's Newton tier's
    # 0.9999999f); float64 keeps its own last step below 1.
    ceiling = 1.0 - (1e-7 if x.dtype == torch.float32 else 2.0**-53)
    return _betainc(a, b, x, lgamma_kernel, 40, ceiling)


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) for the plain path.

    The kernel's continued fraction with ``torch.special.gammaln`` in the
    prefactor, 40 pairs in float32 and 100 in float64.  x is clamped at
    the last float below 1 of its dtype (1 - 2^-24 in float32), not at the
    kernel's 1 - 1e-7: ``jax.scipy.special.betainc`` has no ceiling, and
    under the kernel's every float32 p in the last step below 1 inverts
    to x = 1, a t quantile of 0 near the median.
    """
    a, b, x = _broadcast(a, b, x)
    iters = 100 if a.dtype == torch.float64 else 40
    ceiling = 1.0 - torch.finfo(x.dtype).eps / 2.0  # torch.nextafter(1, 0)
    return _betainc(a, b, x, torch.special.gammaln, iters, ceiling)


def _gammainc_impl():
    return gammainc_kernel if _IN_KERNEL else _gammainc_torch


def _betainc_impl():
    return betainc_kernel if _IN_KERNEL else betainc


def _gammaln_impl():
    return lgamma_kernel if _IN_KERNEL else torch.special.gammaln


def _betaln_impl(a, b):
    lg = _gammaln_impl()
    return lg(a) + lg(b) - lg(a + b)


def _ndtri_impl():
    return ndtri_fast_wide if _IN_KERNEL else torch.special.ndtri


def _wilson_hilferty_gamma_guess(a, p):
    """Initial guess for gammaincinv: Wilson-Hilferty, and for a < 0.5
    (or a non-positive guess) the small-x power law x^a / Gamma(a+1)."""
    s = 1.0 / (9.0 * a)
    z = _ndtri_impl()(p)
    base = 1.0 - s + z * torch.sqrt(s)
    guess = a * (base * base * base)
    small = torch.exp((torch.log(torch.clamp(p, min=_TINY)) + _gammaln_impl()(a + 1.0)) / a)
    guess = torch.where((a < 0.5) | (guess <= 0.0), small, guess)
    return torch.clamp(guess, min=_TINY)


def _tolerances(dtype):
    """(tol, f_tol) of the Newton loops: the step and the residual at
    which a lane freezes."""
    return (3e-5, 1e-4) if dtype == torch.float32 else (1e-15, 1e-12)


def gammaincinv(a, p):
    """Inverse of the regularized lower incomplete gamma function P(a, x).

    Safeguarded Newton in log-space, at most 26 trips.  Each lane freezes
    for good at the first trip where both its step and its residual are
    below tolerance, and keeps the value it had before that step, so a
    lane's trip count and value are its own, whatever batch it is in.
    Only live lanes are computed.
    """
    return newton_gammaincinv(a, p)[0]


def newton_gammaincinv(a, p):
    """``(gammaincinv(a, p), trips)``: ``trips`` is the number of Newton
    trips its lanes took together (what a kernel's lanes would run)."""
    a, p = _broadcast(a, p)
    dtype = a.dtype
    shape = a.shape
    a, p = a.reshape(-1), p.reshape(-1)
    p_c = torch.clamp(p, _TINY, 1.0 - 1e-7 if dtype == torch.float32 else 1.0 - 1e-15)
    log_x = torch.log(_wilson_hilferty_gamma_guess(a, p_c))
    lgam = _gammaln_impl()(a)
    gammainc_fn = _gammainc_impl()
    tol, f_tol = _tolerances(dtype)
    live = torch.arange(a.numel(), device=a.device)
    trips = 0
    for _ in range(_NEWTON_ITERS):
        if live.numel() == 0:
            break
        trips += live.numel()
        la, lx, lp = a[live], log_x[live], p_c[live]
        x = torch.exp(lx)
        f = gammainc_fn(la, x) - lp
        step = f * torch.exp(-(la * lx - x - lgam[live]))
        step = torch.clamp(step, -2.0, 2.0)
        conv = (torch.abs(step) <= tol) & (torch.abs(f) <= f_tol)
        log_x[live] = torch.where(conv, lx, lx - step)
        live = live[~conv]
    x = torch.exp(log_x)
    x = torch.where(p <= 0.0, 0.0, x)
    x = torch.where(p >= 1.0, torch.inf, x)
    return x.reshape(shape), trips


def gammainccinv(a, q):
    """Inverse of the regularized upper incomplete gamma function Q(a, x)."""
    return gammaincinv(a, 1.0 - q)


def _beta_guess(a, b, p):
    """Initial guess for betaincinv: Abramowitz & Stegun 26.5.22, and for
    a <= 1 or b <= 1 (or a non-finite guess) the power-law tail inverse."""
    y = _ndtri_impl()(p)
    la = 1.0 / (2.0 * a - 1.0)
    lb = 1.0 / (2.0 * b - 1.0)
    h = 2.0 / (la + lb)
    w = y * torch.sqrt(h + (y * y - 3.0) / 6.0) / h - (lb - la) * (
        (y * y - 3.0) / 6.0 + 5.0 / 6.0 - 2.0 / (3.0 * h)
    )
    guess = a / (a + b * torch.exp(2.0 * w))
    t = torch.exp((torch.log(torch.clamp(p, min=_TINY)) + _betaln_impl(a, b) + torch.log(a)) / a)
    guess = torch.where((a <= 1.0) | (b <= 1.0) | ~torch.isfinite(guess), t, guess)
    return torch.clamp(guess, 1e-6, 1.0 - 1e-6)


def betaincinv(a, b, p):
    """Inverse of the regularized incomplete beta function I_x(a, b).

    Bisection-safeguarded Newton, at most 26 + 14 trips, with the
    per-lane absorbing freeze of ``gammaincinv``.
    """
    return newton_betaincinv(a, b, p)[0]


def newton_betaincinv(a, b, p):
    """``(betaincinv(a, b, p), trips)``, as ``newton_gammaincinv``."""
    a, b, p = _broadcast(a, b, p)
    dtype = a.dtype
    shape = a.shape
    a, b, p = a.reshape(-1), b.reshape(-1), p.reshape(-1)
    eps = 1e-7 if dtype == torch.float32 else 1e-15
    p_c = torch.clamp(p, eps, 1.0 - eps)
    x = _beta_guess(a, b, p_c)
    lo = torch.zeros_like(x)
    hi = torch.ones_like(x)
    lbeta = _betaln_impl(a, b)
    betainc_fn = _betainc_impl()
    tol, f_tol = _tolerances(dtype)
    live = torch.arange(a.numel(), device=a.device)
    trips = 0
    for _ in range(_NEWTON_ITERS + 14):
        if live.numel() == 0:
            break
        trips += live.numel()
        la, lb, lx, lp = a[live], b[live], x[live], p_c[live]
        f = betainc_fn(la, lb, lx) - lp
        llo = torch.where(f < 0.0, lx, lo[live])
        lhi = torch.where(f > 0.0, lx, hi[live])
        log_pdf = (la - 1.0) * torch.log(lx) + (lb - 1.0) * torch.log1p(-lx) - lbeta[live]
        newton = lx - f * torch.exp(-log_pdf)
        bad = ~torch.isfinite(newton) | (newton <= llo) | (newton >= lhi)
        x_new = torch.where(bad, 0.5 * (llo + lhi), newton)
        rel = torch.abs(x_new - lx) / torch.clamp(lx, min=_TINY)
        conv = (rel <= tol) & (torch.abs(f) <= f_tol)
        x[live] = torch.where(conv, lx, x_new)
        lo[live], hi[live] = llo, lhi
        live = live[~conv]
    x = torch.where(p <= 0.0, 0.0, x)
    x = torch.where(p >= 1.0, 1.0, x)
    return x.reshape(shape), trips


def continuous_ppf_newton(cdf, pdf, q, x0, lo, hi, iters=40):
    """Generic continuous ppf: solve cdf(x) = q by safeguarded Newton.

    ``x0`` is the initial guess and [lo, hi] a bracket with cdf(lo) <= q
    <= cdf(hi); Newton steps that leave the bracket bisect instead.
    Returns the best-|f| iterate seen, as the JAX package does (an
    iterate can cycle within ulps of the root and then be bisected off a
    stale bracket edge).
    """
    shape = q.shape

    def full(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=q.dtype, device=q.device), shape)

    lo, hi = full(lo), full(hi)
    x = torch.minimum(torch.maximum(full(x0), lo), hi)
    best_x = x
    best_f = torch.full(shape, torch.inf, dtype=q.dtype, device=q.device)
    for _ in range(iters):
        f = cdf(x) - q
        af = torch.abs(f)
        better = af < best_f
        best_x = torch.where(better, x, best_x)
        best_f = torch.minimum(af, best_f)
        lo = torch.where(f < 0.0, x, lo)
        hi = torch.where(f > 0.0, x, hi)
        newton = x - f / torch.clamp(pdf(x), min=1e-30)
        bad = ~torch.isfinite(newton) | (newton <= lo) | (newton >= hi)
        x = torch.where(bad, 0.5 * (lo + hi), newton)
    final_f = torch.abs(cdf(x) - q)
    return torch.where(final_f < best_f, x, best_x)


def discrete_ppf_bisect(cdf, q, hi, max_iters=40):
    """Generic discrete ppf: the smallest integer k in [0, hi] with
    cdf(k) >= q.

    ``cdf`` maps a float tensor of ks to CDF values; ``hi`` is a
    per-element upper bound on the support needed.  At most ``max_iters``
    bisection steps, all elements together; the loop stops early once
    every bracket is one wide.  Used by the Poisson/binomial/negative
    binomial ppfs when their parameters are tensors (composite
    distributions).

    The trip cap bounds the loop: above 2^24 the float32 midpoint
    ``floor((lo + hi) / 2)`` can round back onto ``lo`` while ``hi - lo``
    is still > 1, so a width-only condition could spin forever.  On a
    capped exit ``hi`` still satisfies ``cdf(hi) >= q``, correct to one
    float32 ulp of the support.
    """
    lo = torch.full(q.shape, -1.0, dtype=q.dtype, device=q.device)  # cdf(lo) < q
    hi = torch.broadcast_to(torch.as_tensor(hi, dtype=q.dtype, device=q.device), q.shape)
    for _ in range(max_iters):
        if not bool((hi - lo > 1.0).any()):
            break
        mid = torch.floor((lo + hi) / 2.0)
        go_right = cdf(mid) < q
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return hi


def t_cdf(x, df):
    """Student-t CDF through the regularized incomplete beta function:
    ``P(T <= x) = 1 - I_z(df/2, 1/2) / 2`` for ``x >= 0`` with
    ``z = df / (df + x^2)``, mirrored below zero.  The tail is the
    computed quantity, so both tails keep their relative accuracy.
    float32 takes the kernel's 40-pair ``betainc_kernel`` (as the JAX
    package's float32 path does), float64 ``betainc``."""
    dtype = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(dtype)
    df = torch.as_tensor(df, dtype=dtype, device=x.device)
    z = df / (df + x * x)
    half = torch.full((), 0.5, dtype=dtype, device=x.device)
    incomplete = betainc_kernel if dtype == torch.float32 else betainc
    tail = 0.5 * incomplete(0.5 * df, half, z)
    return torch.where(x >= 0, 1.0 - tail, tail)


def chi2_draws(generator, df, n, dtype, device):
    """(n,) chi-square(df) draws from ``generator`` (the t copula's and the
    gamma frailty's mixing).

    Integer df in [1, 128] takes the exact loop-free decomposition
    ``chi2(2k + r) = -2 log(U_1 ... U_k) + r Z^2``: k uniforms and, for odd
    df, one normal.  Any other df inverts the incomplete gamma function of
    one uniform (``gammaincinv``).
    """
    from probabilit_tpu_torch.ops.qmc import clamp_open_unit

    fdf = float(df)
    if fdf.is_integer() and 1.0 <= fdf <= 128.0:
        k, r = divmod(int(fdf), 2)
        w = torch.zeros((n,), dtype=dtype, device=device)
        if k:
            u = clamp_open_unit(torch.rand((k, n), generator=generator, dtype=dtype, device=device))
            w = -2.0 * torch.log(u).sum(dim=0)
        if r:
            z = torch.randn((n,), generator=generator, dtype=dtype, device=device)
            w = w + z * z
        return torch.clamp(w, min=torch.finfo(dtype).tiny)
    u = clamp_open_unit(torch.rand((n,), generator=generator, dtype=dtype, device=device))
    return 2.0 * gammaincinv(torch.full((n,), 0.5 * fdf, dtype=dtype, device=device), u)
