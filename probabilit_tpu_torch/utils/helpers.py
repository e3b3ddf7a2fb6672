"""Host-side utilities: the port's copy of ``probabilit_tpu/utils/helpers.py``."""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["build_corrmat", "zip_args", "adjust_minmax_quantiles"]


def build_corrmat(correlations):
    """Scatter sub-correlation-matrices into one big identity-based matrix.

    Unspecified pairs are implicitly 0.

    Examples
    --------
    >>> correlations = [((0, 2), np.array([[1, 0.5], [0.5, 1]]))]
    >>> build_corrmat(correlations)
    array([[1. , 0. , 0.5],
           [0. , 1. , 0. ],
           [0.5, 0. , 1. ]])
    """
    n = max(max(idx) for (idx, _) in correlations)
    C = np.eye(n + 1, dtype=float)
    for idx_i, corrmat_i in correlations:
        C[np.ix_(idx_i, idx_i)] = corrmat_i
    return C


def zip_args(args, kwargs):
    """Turn per-argument streams into a stream of per-call ``(args, kwargs)``.

    Each entry of ``args``/``kwargs`` is an iterable giving that argument's
    value for call 0, 1, 2, ...; the output yields one positional tuple and
    one keyword dict per call, stopping with the shortest stream.

    Examples
    --------
    >>> calls = zip_args((("x", "y"),), {"n": (10, 20)})
    >>> for args_i, kwargs_i in calls:
    ...     print(args_i, kwargs_i)
    ('x',) {'n': 10}
    ('y',) {'n': 20}
    """
    if not args and not kwargs:
        # No argument streams: zero calls (two endless repeat(()) streams
        # would otherwise yield ((), {}) forever).
        return
    names = list(kwargs)
    positional = zip(*args) if args else itertools.repeat(())
    keyword = zip(*(kwargs[k] for k in names)) if names else itertools.repeat(())
    for pos_i, kw_i in zip(positional, keyword):
        yield pos_i, dict(zip(names, kw_i))


def _histogram_mean(quantiles, cumulatives):
    """Mean of the histogram with bin edges ``cumulatives`` and per-bin
    probability mass proportional to ``diff(quantiles)``: the
    mass-weighted sum of the bin midpoints."""
    w = np.diff(np.asarray(quantiles, float))
    edges = np.asarray(cumulatives, float)
    mid = 0.5 * (edges[:-1] + edges[1:])
    return float(np.sum(w * mid) / np.sum(w))


def adjust_minmax_quantiles(quantiles, cumulatives, expected):
    """Adjust the endpoint cumulatives so the histogram mean hits ``expected``.

    Optimises log-scale stretches of the first and last bin edge with
    Nelder-Mead, lightly regularised toward the original endpoints.

    Examples
    --------
    >>> adjust_minmax_quantiles([0, 0.5, 1], [0, 5, 6], expected=4.0)
    array([0., 5., 6.])
    """
    import scipy.optimize

    quantiles = np.array(quantiles, dtype=float)
    cumulatives = np.array(cumulatives, dtype=float)
    assert np.all(np.diff(quantiles) > 0)
    assert np.all(np.diff(cumulatives) > 0)
    assert np.isclose(np.min(quantiles), 0)
    assert np.isclose(np.max(quantiles), 1)

    q1, q2 = cumulatives[:2]
    qn1, qn = cumulatives[-2:]

    def endpoints(params):
        low_scale, high_scale = params
        low = min(q2 - np.exp(low_scale) * (q2 - q1), q2 - 1e-6)
        high = max(qn1 + np.exp(high_scale) * (qn - qn1), qn1 + 1e-6)
        return low, high

    def objective(params):
        low, high = endpoints(params)
        trial = cumulatives.copy()
        trial[0], trial[-1] = low, high
        mean_err = abs(_histogram_mean(quantiles, trial) - expected)
        drift = (low - cumulatives[0]) ** 2 + (high - cumulatives[-1]) ** 2
        return mean_err + 1e-2 * drift

    result = scipy.optimize.minimize(objective, x0=[0.0, 0.0], method="nelder-mead")
    low, high = endpoints(result.x)
    out = cumulatives.copy()
    out[0], out[-1] = low, high
    return out
