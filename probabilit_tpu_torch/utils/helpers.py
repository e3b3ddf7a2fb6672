"""Host-side utilities: the port's copy of ``probabilit_tpu/utils/helpers.py``.

Only ``build_corrmat`` is carried over so far (the correlated path needs
it); ``zip_args`` and ``adjust_minmax_quantiles`` wait for ROADMAP A10.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_corrmat"]


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
