"""The plain reference's ppf of sii_nonlife12's claim counts (poisson).

The float64 probability mass function is written out from ``lgamma``,
cumulated over a support that reaches 1 to within 1e-16, and cached by
its parameters.  The value at q is the smallest k whose CDF is at least
q, as scipy's discrete ``ppf`` defines it: ``searchsorted(cdf, q,
side="left")``, on the device that holds q.  Plain PyTorch: nothing of
the program, no scipy.
"""

from __future__ import annotations

import math

import torch

TAIL = 1e-20  # the support ends past its mode where the mass falls below this
_TABLES = {}  # (mu, device) -> cdf, float64, from k = 0


def _poisson_pmf(mu):
    """The pmf on 0, 1, ...: the support doubles until its last mass is
    below ``TAIL`` and falling, so that what it leaves out of the CDF is
    below 1e-16."""
    hi = 64
    while True:
        k = torch.arange(hi, dtype=torch.float64)
        lp = k * math.log(mu) - mu - torch.lgamma(k + 1.0)
        if lp[-1] < math.log(TAIL) and lp[-1] < lp[-2]:
            return torch.exp(lp)
        hi *= 2


def table(mu, device):
    key = (float(mu), str(device))
    if key not in _TABLES:
        pmf = _poisson_pmf(float(mu))
        _TABLES[key] = torch.cumsum(pmf / pmf.sum(), 0).to(device)
    return _TABLES[key]


def _poisson_ppf(p, q):
    cdf = table(p["mu"], q.device)
    k = torch.searchsorted(cdf, q.to(torch.float64).contiguous(), side="left")
    return torch.clamp(k, max=len(cdf) - 1).to(torch.float64)


PPFS = {"poisson": _poisson_ppf}
