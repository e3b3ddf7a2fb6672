"""K1's Newton tier in PyTorch: what ``csrc/newton_ops.cuh`` computes per lane.

The generated kernel solves a Newton family's quantile (the families of
``cuda_exec.INCOMPLETE_FAMILY_CAPS``) with ``newton_ops::solve``: the
family's inverse arguments (``family_args``), the safeguarded Newton loop
of the twin (``ops/special.py``'s ``newton_gammaincinv`` and
``newton_betaincinv`` under ``kernel_safe_special``) around a series or
continued fraction that stops where it has converged rather than after a
fixed count, and the family's value from the inverse (``family_value``).
This module transcribes that loop lane by lane on float32 tensors, with
the kernel's stopping rules and per-lane freeze, and counts what each
lane took: its Newton trips and its series terms or fraction pairs.  The
order in which the kernel's warps take the lanes does not enter: a lane's
arithmetic is its own.

The tests hold it to the twin and to the JAX package; ``chip_smoke.py``
prices the kernel's work by its counts.  The kernel may contract a
multiply and an add where this rounds twice, so the two agree to rounding,
not bitwise.
"""

from __future__ import annotations

import torch

from probabilit_tpu_torch.ops import special as _special

__all__ = [
    "STOP",
    "GAMMA_TRIPS",
    "BETA_TRIPS",
    "GAMMA_TERMS",
    "BETA_PAIRS",
    "family_args",
    "family_value",
    "gammaincinv",
    "betaincinv",
    "ppf",
]

STOP = 2.0**-24  # series: term <= total * STOP; fractions: |d c - 1| <= STOP
GAMMA_TRIPS, BETA_TRIPS = 26, 40  # the twin's trip caps
GAMMA_TERMS, BETA_PAIRS = 48, 40  # the twin's fixed counts, now caps
_TINY = 1e-30


def _f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device).expand_as(like)


def family_args(family, q, shapes):
    """``(kind, a, b, p)`` of ``ppf_<family>_args``: the inverse a family
    asks for, ``"gamma"`` (P(a, x) = p, ``b`` None) or ``"beta"``
    (I_x(a, b) = p), on the float32 quantiles ``q``."""
    s = [_f32(v, q) for v in shapes]
    one = torch.ones_like(q)
    if family in ("gamma", "nakagami", "loggamma"):
        return "gamma", s[0], None, q
    if family == "invgamma":
        return "gamma", s[0], None, 1.0 - q
    if family in ("chi2", "chi"):
        return "gamma", 0.5 * s[0], None, q
    if family == "maxwell":
        return "gamma", 1.5 * one, None, q
    if family == "dgamma":
        p = torch.where(q < 0.5, 1.0 - torch.clamp(2.0 * q, 1e-7, 1.0),
                        torch.clamp(2.0 * q - 1.0, 0.0, 0.9999999))
        return "gamma", s[0], None, p
    if family == "gengamma":
        return "gamma", s[0], None, q if float(s[1].reshape(-1)[0]) > 0 else 1.0 - q
    if family == "argus":
        return "gamma", 1.5 * one, None, (1.0 - q) * _argus_p_chi(s[0])
    if family in ("beta", "betaprime"):
        return "beta", s[0], s[1], q
    if family == "t":
        return "beta", 0.5 * s[0], 0.5 * one, 2.0 * torch.minimum(q, 1.0 - q)
    if family == "f":
        return "beta", 0.5 * s[0], 0.5 * s[1], q
    if family == "rdist":
        return "beta", 0.5 * s[0], 0.5 * s[0], q
    raise KeyError(family)


def _argus_p_chi(chi):
    return _special.gammainc_kernel(torch.full_like(chi, 1.5), 0.5 * chi * chi)


def family_value(family, q, x, shapes):
    """``ppf_<family>_value``: the family's standard variate from its
    inverse ``x`` at the quantiles ``q``."""
    s = [_f32(v, q) for v in shapes]
    if family in ("gamma", "beta"):
        return x
    if family == "invgamma":
        return 1.0 / x
    if family == "chi2":
        return 2.0 * x
    if family in ("chi", "maxwell"):
        return torch.sqrt(2.0 * x)
    if family == "nakagami":
        return torch.sqrt(x / s[0])
    if family == "betaprime":
        return x / (1.0 - x)
    if family == "t":
        tval = torch.sqrt(s[0] * (1.0 - x) / torch.clamp(x, min=1e-30))
        return torch.where(q < 0.5, -tval, tval)
    if family == "f":
        return (s[1] * x) / (s[0] * (1.0 - x))
    if family == "dgamma":
        return torch.where(q < 0.5, -x, x)
    if family == "loggamma":
        return torch.log(x)
    if family == "gengamma":
        return _special.pow(x, 1.0 / s[1])
    if family == "rdist":
        return 2.0 * x - 1.0
    if family == "argus":
        return _argus_value(q, x, s[0])
    raise KeyError(family)


def _argus_value(q, u, chi):
    a = 0.5 * chi * chi
    p_chi = _argus_p_chi(chi)
    x = torch.sqrt(torch.clamp(1.0 - u / a, min=0.0))
    k = chi * chi * chi * torch.exp(-a) / (2.5066282746310002 * 0.5 * p_chi)
    c2 = 0.25 * (a - 0.5)
    c3 = (0.5 * a * a - 0.5 * a - 0.125) / 6.0
    target = q / k
    y = 2.0 * target
    for _ in range(2):
        g = y * (0.5 + y * (c2 + y * c3))
        gp = 0.5 + y * (2.0 * c2 + y * 3.0 * c3)
        y = torch.clamp(y - (g - target) / gp, min=0.0)
    use_series = x * x < 0.05 / torch.clamp(a, min=1.0)
    return torch.where(use_series, torch.sqrt(torch.clamp(y, min=0.0)), x)


def _guard(v):
    return torch.where(torch.abs(v) < _TINY, torch.full_like(v, _TINY), v)


def _where(mask, new, old):
    return torch.where(mask, new, old)


def _gammainc(a, x, lgam, live):
    """P(a, x) as ``begin_trip`` / ``fraction_step`` / ``end_trip`` compute
    it on the lanes ``live``: the series for x < a + 1 until a term is at
    most the sum times ``STOP``, else the fraction for Q until |d c - 1| <=
    ``STOP``, each at most ``GAMMA_TERMS`` long; returns (P, terms)."""
    xs = torch.clamp(x, min=_TINY)
    log_pre = a * torch.log(xs) - xs - lgam
    series = xs < a + 1.0
    # The series: d its term, h its sum.  The fraction: Lentz's c, d, h.
    d = torch.where(series, 1.0 / a, 1.0 / _guard(xs + 1.0 - a))
    h = d.clone()
    c = torch.full_like(x, 1e30)
    going = live.clone()
    terms = torch.zeros_like(x, dtype=torch.int32)
    for k in range(GAMMA_TERMS):
        d_s = d * xs / (a + 1.0 + k)
        h_s = h + d_s
        i1 = k + 1.0
        an = -i1 * (i1 - a)
        bb = xs + 1.0 - a + 2.0 * i1
        d_f = 1.0 / _guard(bb + an * d)
        c_f = _guard(bb + an / c)
        h_f = h * d_f * c_f
        d_new = torch.where(series, d_s, d_f)
        h_new = torch.where(series, h_s, h_f)
        done = torch.where(series, d_s <= h_s * STOP, torch.abs(d_f * c_f - 1.0) <= STOP)
        d, h = _where(going, d_new, d), _where(going, h_new, h)
        c = _where(going & ~series, c_f, c)
        terms = terms + going.to(torch.int32)
        going = going & ~done
        if not bool(going.any()):
            break
    p = torch.where(series, h * torch.exp(log_pre), 1.0 - torch.exp(log_pre) * h)
    p = torch.where(x <= 0.0, 0.0, p)
    return torch.clamp(p, 0.0, 1.0), terms


def _betacf(a, b, x, live):
    """Lentz's fraction of I_x(a, b) in even/odd pairs until |d c - 1| <=
    ``STOP`` after a pair, at most ``BETA_PAIRS``; returns (h, pairs)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / _guard(1.0 - qab * x / qap)
    h = d.clone()
    going = live.clone()
    pairs = torch.zeros_like(x, dtype=torch.int32)
    for m1 in range(BETA_PAIRS):
        m = m1 + 1.0
        two_m = 2.0 * m
        aa = m * (b - m) * x / ((qam + two_m) * (a + two_m))
        d1 = 1.0 / _guard(1.0 + aa * d)
        c1 = _guard(1.0 + aa / c)
        h1 = h * d1 * c1
        aa = -(a + m) * (qab + m) * x / ((a + two_m) * (qap + two_m))
        d2 = 1.0 / _guard(1.0 + aa * d1)
        c2 = _guard(1.0 + aa / c1)
        h2 = h1 * d2 * c2
        d, c, h = _where(going, d2, d), _where(going, c2, c), _where(going, h2, h)
        pairs = pairs + going.to(torch.int32)
        going = going & ~(torch.abs(d2 * c2 - 1.0) <= STOP)
        if not bool(going.any()):
            break
    return h, pairs


def _betainc(a, b, x, lgab, live):
    """I_x(a, b), one fraction on the operands each lane selects."""
    xc = torch.clamp(x, _TINY, 0.9999999)
    bt = torch.exp(lgab + a * torch.log(xc) + b * torch.log1p(-xc))
    direct = xc < (a + 1.0) / (a + b + 2.0)
    h, pairs = _betacf(torch.where(direct, a, b), torch.where(direct, b, a),
                       torch.where(direct, xc, 1.0 - xc), live)
    p = torch.where(direct, bt * h / a, 1.0 - bt * h / b)
    p = torch.where(x <= 0.0, 0.0, p)
    p = torch.where(x >= 1.0, 1.0, p)
    return torch.clamp(p, 0.0, 1.0), pairs


def gammaincinv(a, p):
    """``(x, trips, terms)``: the kernel's inverse of P(a, x) on float32
    ``a`` and ``p``, with each lane's Newton trips and the series terms or
    fraction steps of all its trips."""
    a, p = torch.broadcast_tensors(a.to(torch.float32), p.to(torch.float32))
    lg = _special.lgamma_kernel
    lgam, lgam1 = lg(a), lg(a + 1.0)
    p_c = torch.clamp(p, _TINY, 0.9999999)
    s = 1.0 / (9.0 * a)
    z = _special.ndtri_fast_wide(p_c)
    base = 1.0 - s + z * torch.sqrt(s)
    guess = a * (base * base * base)
    small = torch.exp((torch.log(torch.clamp(p_c, min=_TINY)) + lgam1) / a)
    guess = torch.where((a < 0.5) | (guess <= 0.0), small, guess)
    log_x = torch.log(torch.clamp(guess, min=_TINY))
    live = torch.ones_like(p, dtype=torch.bool)
    trips = torch.zeros_like(p, dtype=torch.int32)
    terms = torch.zeros_like(p, dtype=torch.int32)
    for _ in range(GAMMA_TRIPS):
        x = torch.exp(log_x)
        value, taken = _gammainc(a, x, lgam, live)
        f = value - p_c
        step = torch.clamp(f * torch.exp(-(a * log_x - x - lgam)), -2.0, 2.0)
        frozen = (torch.abs(step) <= 3e-5) & (torch.abs(f) <= 1e-4)
        trips = trips + live.to(torch.int32)
        terms = terms + torch.where(live, taken, 0)
        log_x = _where(live & ~frozen, log_x - step, log_x)
        live = live & ~frozen
        if not bool(live.any()):
            break
    x = torch.exp(log_x)
    x = torch.where(p <= 0.0, 0.0, x)
    x = torch.where(p >= 1.0, torch.inf, x)
    return x, trips, terms


def betaincinv(a, b, p):
    """``(x, trips, pairs)``: the kernel's inverse of I_x(a, b) on float32
    ``a``, ``b`` and ``p``, with each lane's Newton trips and the fraction
    pairs of all its trips."""
    a, b, p = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32),
                                      p.to(torch.float32))
    lg = _special.lgamma_kernel
    lg_a, lg_b, lg_ab = lg(a), lg(b), lg(a + b)
    lbeta, lgab = lg_a + lg_b - lg_ab, lg_ab - lg_a - lg_b
    p_c = torch.clamp(p, 1e-7, 0.9999999)
    y = _special.ndtri_fast_wide(p_c)
    la = 1.0 / (2.0 * a - 1.0)
    lb = 1.0 / (2.0 * b - 1.0)
    h = 2.0 / (la + lb)
    w = y * torch.sqrt(h + (y * y - 3.0) / 6.0) / h - (lb - la) * (
        (y * y - 3.0) / 6.0 + 0.8333333333333334 - 2.0 / (3.0 * h))
    guess = a / (a + b * torch.exp(2.0 * w))
    tail = torch.exp((torch.log(torch.clamp(p_c, min=_TINY)) + lbeta + torch.log(a)) / a)
    guess = torch.where((a <= 1.0) | (b <= 1.0) | ~torch.isfinite(guess), tail, guess)
    x = torch.clamp(guess, 1e-6, 0.999999)
    lo, hi = torch.zeros_like(x), torch.ones_like(x)
    live = torch.ones_like(p, dtype=torch.bool)
    trips = torch.zeros_like(p, dtype=torch.int32)
    pairs = torch.zeros_like(p, dtype=torch.int32)
    for _ in range(BETA_TRIPS):
        value, taken = _betainc(a, b, x, lgab, live)
        f = value - p_c
        lo = _where(live & (f < 0.0), x, lo)
        hi = _where(live & (f > 0.0), x, hi)
        log_pdf = (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - lbeta
        newton = x - f * torch.exp(-log_pdf)
        bad = ~torch.isfinite(newton) | (newton <= lo) | (newton >= hi)
        x_new = torch.where(bad, 0.5 * (lo + hi), newton)
        frozen = (torch.abs(x_new - x) / torch.clamp(x, min=_TINY) <= 3e-5) & (
            torch.abs(f) <= 1e-4)
        trips = trips + live.to(torch.int32)
        pairs = pairs + torch.where(live, taken, 0)
        x = _where(live & ~frozen, x_new, x)
        live = live & ~frozen
        if not bool(live.any()):
            break
    x = torch.where(p <= 0.0, 0.0, x)
    x = torch.where(p >= 1.0, 1.0, x)
    return x, trips, pairs


def ppf(family, q, shapes):
    """``(value, kind, trips, inner)``: a Newton family's standard variate
    at the float32 quantiles ``q`` as the kernel's Newton tier computes
    it, the kind of its inverse, and each lane's Newton trips and series
    terms or fraction pairs (``inner``)."""
    q = q.to(torch.float32)
    kind, a, b, p = family_args(family, q, shapes)
    if kind == "gamma":
        x, trips, inner = gammaincinv(a, p)
    else:
        x, trips, inner = betaincinv(a, b, p)
    return family_value(family, q, x, shapes), kind, trips, inner
