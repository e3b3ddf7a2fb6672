"""Permutation-based correlation refinement.

Port of ``probabilit_tpu/ops/permutation.py``.  Three pieces:

* :class:`CorrelationMatrix`: O(s*n) incremental correlation updates under
  row swaps within one column (host numpy, the bookkeeping API of tests
  and small-sample workflows; the JAX package's code, so the same numpy
  generator gives the same results bit for bit).
* :class:`SwapIndexGenerator`: streams disjoint index pairs (host numpy).
* :class:`PermutationCorrelator`: randomised hill-climbing that permutes
  rows within columns until corr(X) approaches a target.  The climb runs
  on the device: each step proposes a batch of swaps, computes the O(s*K)
  correlation delta, and accepts and commits with ``torch.where``, with
  no host read; the proposals of several iterations are drawn at once,
  and the tolerance is read back once every ``_CHECK_EVERY`` iterations.
  The JAX package runs the climb as one ``lax.while_loop``; the port's
  proposals come from a ``torch.Generator`` of ``seed``, so its climb
  follows the same laws on other bits.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from probabilit_tpu_torch.ops.correlation import Correlator, _as_tensor, _full_float32

__all__ = ["CorrelationMatrix", "SwapIndexGenerator", "PermutationCorrelator"]

# Iterations (cycles over the columns) between two reads of the error.
_CHECK_EVERY = 8


def _rankdata_np(X, axis=0):
    """Average-tie ranks (1-based) along an axis, scipy-compatible."""
    import scipy.stats

    return np.apply_along_axis(scipy.stats.rankdata, axis, X)


class CorrelationMatrix:
    """Fast incremental correlation updates when swapping rows in a column.

    Recomputing corr(X) after a swap costs O(m n^2); only row/column ``k``
    of the correlation matrix changes, and of the Pearson numerator
    ``sum x_i y_i`` only the swapped terms change, giving O(s n) per
    proposal.

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> X = rng.normal(size=(9, 4))
    >>> cm = CorrelationMatrix(X)
    >>> new_col = cm.update_column(col=0, i=2, j=3)
    >>> X[2, 0], X[3, 0] = X[3, 0], X[2, 0]
    >>> bool(np.allclose(new_col, np.corrcoef(X, rowvar=False)[:, 0]))
    True
    """

    def __init__(self, X, correlation_type="pearson", check=True):
        valid_corrs = ("pearson", "spearman")
        assert correlation_type in valid_corrs
        assert X.ndim == 2

        self.correlation_type = correlation_type
        self.check = check
        self.X = np.array(X, dtype=float, copy=True)

        if correlation_type == "pearson":
            self.X_ = self.X
        else:  # spearman: Pearson on the column ranks
            self.X_ = _rankdata_np(self.X, axis=0)

        self.m, self.n = self.X_.shape
        centered = self.X_ - np.mean(self.X_, axis=0)
        self.numerator = (centered.T @ centered) / self.m
        self.denominator = np.std(centered, axis=0)
        if np.any(np.isclose(self.denominator, 0)):
            raise ValueError("X has one or several constant columns")
        self.corr_mat = self.numerator / np.outer(self.denominator, self.denominator)

    def __repr__(self):
        return repr(self.corr_mat)

    def __getitem__(self, *args, **kwargs):
        return self.corr_mat.__getitem__(*args, **kwargs)

    def _delta_numerator(self, col, i, j):
        """Change of numerator row ``col`` when swapping rows i <-> j there."""
        if self.check:
            assert isinstance(col, (int, np.integer))
            assert 0 <= col < self.n
            if isinstance(i, (int, np.integer)):
                i = [i]
            if isinstance(j, (int, np.integer)):
                j = [j]
            assert len(i) == len(j)
            if set(np.asarray(i).tolist()).intersection(set(np.asarray(j).tolist())):
                raise ValueError(f"Swaps must be two disjoint sets, got {i} and {j}")

        rows_i = self.X_[i, :]
        rows_j = self.X_[j, :]
        swap_delta = (rows_j[:, col] - rows_i[:, col])[:, None]
        delta = np.sum((rows_i - rows_j) * swap_delta, axis=0)
        delta[col] = 0.0
        return delta

    def delta_column(self, col, i, j):
        """Change of correlation column ``col`` for the proposed swap."""
        delta = self._delta_numerator(col, i, j)
        return delta / (self.m * self.denominator * self.denominator[col])

    def update_column(self, col, i, j):
        """New value of correlation column ``col`` for the proposed swap."""
        return self.corr_mat[:, col] + self.delta_column(col, i, j)

    def commit(self, col, i, j):
        """Apply a proposed swap: update data, numerator and correlations."""
        delta_num = self._delta_numerator(col, i, j)
        delta_col = delta_num / (self.m * self.denominator * self.denominator[col])

        self.corr_mat[:, col] += delta_col
        self.corr_mat[col, :] += delta_col
        # The numerator is stored / m (see __init__), so the raw sum-delta
        # is scaled to match.
        self.numerator[:, col] += delta_num / self.m
        self.numerator[col, :] += delta_num / self.m

        self.X_[i, col], self.X_[j, col] = self.X_[j, col], self.X_[i, col]
        if self.correlation_type == "spearman":
            self.X[i, col], self.X[j, col] = self.X[j, col], self.X[i, col]
        return self


@dataclasses.dataclass
class SwapIndexGenerator:
    """Streams tuples of disjoint index arrays from a recycled permutation.

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> gen = SwapIndexGenerator(rng=rng, n=9)
    >>> i, j = gen(2)
    >>> len(set(i.tolist()) & set(j.tolist()))
    0
    """

    def __init__(self, rng, n: int):
        assert n >= 2
        self.rng = rng
        self.indices = np.arange(n)
        self.permutation = self.rng.permutation(self.indices)

    def __call__(self, size: int):
        assert size >= 1
        size = min(size, len(self.indices) // 2)
        chosen = self.permutation[: 2 * size]
        self.permutation = self.permutation[2 * size :]
        if len(chosen) < 2 * size:
            self.permutation = self.rng.permutation(self.indices)
            return self.__call__(size=size)
        return chosen[:size], chosen[size:]


class PermutationCorrelator(Correlator):
    """Randomised hill-climbing correlation induction by row permutation.

    Cycles through the columns, proposes batches of row swaps whose size
    follows a closed-form cooling schedule (``subiters``), accepts the
    proposals that reduce the weighted error against the target, and stops
    on tolerance or after ``iterations`` cycles (``iterations=0``: until
    tolerance).  Supports "pearson" and "spearman" and elementwise
    weights.  Every output column is a permutation of its input.

    Examples
    --------
    >>> rng = np.random.default_rng(42)
    >>> X = rng.normal(size=(100, 2))
    >>> target = np.array([[1, 0.7], [0.7, 1]])
    >>> pc = PermutationCorrelator(seed=0).set_target(target)
    >>> X_t = np.asarray(pc(X).cpu())          # doctest: +SKIP
    >>> bool(abs(np.corrcoef(X_t, rowvar=False)[0, 1] - 0.7) < 0.1)   # doctest: +SKIP
    True
    """

    def __init__(
        self,
        *,
        weights=None,
        iterations=1000,
        tol=0.01,
        correlation_type="pearson",
        seed=None,
        verbose=False,
    ):
        if weights is not None and not np.all(weights > 0):
            raise ValueError(
                "Every entry of weights must be strictly positive."
            )
        if not isinstance(iterations, int) or iterations < 0:
            raise ValueError(
                f"iterations must be an integer >= 0, got {iterations!r}."
            )
        if not isinstance(tol, (int, float)) or tol <= 0:
            raise ValueError(f"tol must be a number > 0, got {tol!r}.")
        if seed is not None and not isinstance(seed, int):
            raise TypeError(f"seed must be None or an int, got {seed!r}.")
        if not isinstance(verbose, bool):
            raise TypeError(f"verbose must be a bool, got {verbose!r}.")

        self.iters = iterations
        self.tol = tol
        self.seed = seed if seed is not None else np.random.SeedSequence().entropy % 2**31
        self.verbose = verbose
        self.correlation_type = correlation_type
        if weights is not None:
            self._init_weights = np.asarray(weights, float)
        else:
            self._init_weights = None

    def set_target(self, correlation_matrix, *, weights=None):
        super().set_target(correlation_matrix)
        if weights is None:
            weights = (
                self._init_weights
                if self._init_weights is not None
                else np.ones_like(self.C)
            )
        self.weights = weights / np.sum(weights)
        self.triu_indices = np.triu_indices(self.C.shape[0], k=1)
        return self

    def _error(self, observed, target):
        """Weighted RMSE over the strict upper triangle."""
        idx = self.triu_indices
        observed = np.asarray(observed)
        target = np.asarray(target)
        weighted = self.weights[idx] * (observed[idx] - target[idx]) ** 2.0
        return float(np.sqrt(np.sum(weighted)))

    @staticmethod
    def subiters(n, i):
        """Cooling schedule: swap batch size at iteration ``i`` of ``n``.

        Closed form of the halving pattern [C, ..., 2, 2, 1, 1, 1, 1] with
        C = log2(n) + 1.
        """
        C = np.log2(n) + 1
        return int(np.ceil(C ** (1 - (2 * i / n))))

    def __call__(self, X):
        self._validate_X(X, check_rows_cols=False)
        num_obs, num_vars = X.shape
        if not num_vars == self.C.shape[0]:
            raise ValueError(
                "Number of variables in `X` does not match `correlation_matrix`."
            )
        return self._apply(_as_tensor(X))

    def _proposals(self, gen, steps, num_obs, max_pairs, small_n):
        """(ii, jj, ok) for ``steps`` steps, each ``(steps, max_pairs)``.

        Few rows: the pairs of a fresh permutation a step (exactly
        disjoint; independent draws would collide on nearly every step).
        Many rows: independent draws, the pairs that share a row rejected.
        """
        device = gen.device
        if small_n:
            u = torch.rand((steps, num_obs), generator=gen, device=device)
            flat = torch.argsort(u, dim=1)[:, : 2 * max_pairs]
            ok = torch.ones((steps, max_pairs), dtype=torch.bool, device=device)
        else:
            flat = torch.randint(0, num_obs, (steps, 2 * max_pairs), generator=gen,
                                 device=device)
            same = flat[:, :, None] == flat[:, None, :]
            has_dup = same.sum(dim=2) > 1
            ok = ~(has_dup[:, :max_pairs] | has_dup[:, max_pairs:])
        return flat[:, :max_pairs], flat[:, max_pairs:], ok

    def _apply(self, X):
        num_obs, num_vars = X.shape
        device, dtype = X.device, X.dtype
        # iterations=0 means "run until tolerance", with the cooling schedule
        # at n = 10,000, as the JAX package does.
        unbounded = self.iters == 0
        n_sched = self.iters if self.iters else 10_000
        cooling_c = np.log2(n_sched) + 1.0
        # A swap batch can never exceed floor(N/2) disjoint pairs; when the
        # schedule's ceiling crowds the row count, proposals come from
        # permutations (exactly disjoint pairs).
        max_pairs = max(1, min(int(np.ceil(cooling_c)), num_obs // 2))
        small_n = num_obs < 4 * int(np.ceil(cooling_c))

        spearman = self.correlation_type == "spearman"
        if spearman:
            from probabilit_tpu_torch.ops.correlation import rankdata

            Xw = rankdata(X, axis=0).to(dtype) + 1.0
        else:
            Xw = X.clone()
        Xo = X.clone() if spearman else Xw

        target = torch.as_tensor(self.C, dtype=dtype, device=device)
        weights = torch.as_tensor(self.weights, dtype=dtype, device=device)
        triu_w = torch.where(
            torch.triu(torch.ones((num_vars, num_vars), dtype=torch.bool, device=device), 1),
            weights, torch.zeros((), dtype=dtype, device=device),
        )
        with _full_float32():
            centered = Xw - Xw.mean(dim=0)
            numerator = (centered.T @ centered) / num_obs
        denominator = Xw.std(dim=0, unbiased=False)
        corr = numerator / torch.outer(denominator, denominator)

        def full_error(c):
            return torch.sqrt(torch.sum(triu_w * (c - target) ** 2))

        tol = self.tol
        gen = torch.Generator(device=device)
        gen.manual_seed(int(self.seed))
        print_every = self.iters // 10 if self.iters >= 10 else 0
        if self.verbose:
            print(
                "Running permutation correlator for "
                f"{self.iters if self.iters else 'inf'} iterations."
            )

        err = full_error(corr)
        iteration = 0
        zero = torch.zeros((), dtype=dtype, device=device)
        while True:
            # Tolerance (one host read); a NaN error (a constant or
            # non-finite column) stops the climb with the data unchanged.
            err_now = float(err)
            if not err_now >= tol:
                if unbounded and math.isnan(err_now):
                    warnings.warn(
                        "PermutationCorrelator error is NaN (constant or "
                        "non-finite column?); returning the data unchanged.",
                        stacklevel=3,
                    )
                break
            if not unbounded and iteration >= self.iters:
                break
            if iteration * num_vars >= 2**31:
                raise RuntimeError(
                    "PermutationCorrelator(iterations=0) did not reach "
                    f"tol={tol} within 2^31 column steps; the target "
                    "correlation may be unreachable for this data."
                )
            cycles = _CHECK_EVERY if unbounded else min(_CHECK_EVERY, self.iters - iteration)
            ii_all, jj_all, ok_all = self._proposals(gen, cycles * num_vars, num_obs,
                                                    max_pairs, small_n)
            for c in range(cycles):
                iteration += 1
                m = min(int(np.ceil(cooling_c ** (1.0 - 2.0 * iteration / n_sched))), max_pairs)
                if self.verbose and print_every and iteration % print_every == 0:
                    print(f" Iter {iteration:>6}  Error: {float(err):.6f} Swaps: {m:>2}")
                for k in range(num_vars):
                    s = c * num_vars + k
                    ii, jj, ok = ii_all[s, :m], jj_all[s, :m], ok_all[s, :m]
                    rows_i, rows_j = Xw[ii], Xw[jj]
                    swap_delta = (rows_j[:, k] - rows_i[:, k])[:, None]
                    delta_num = torch.where(ok[:, None], (rows_i - rows_j) * swap_delta,
                                            zero).sum(dim=0)
                    delta_num[k] = 0.0
                    delta_col = delta_num / (num_obs * denominator * denominator[k])
                    old_col = corr[:, k]
                    w = weights[k]
                    old_err = torch.sum(w * (target[:, k] - old_col) ** 2)
                    new_err = torch.sum(w * (target[:, k] - (old_col + delta_col)) ** 2)
                    accept = new_err < old_err
                    step = torch.where(accept, delta_col, zero)
                    corr[:, k] += step
                    corr[k, :] += step
                    take = ok & accept
                    for Y in (Xw, Xo) if spearman else (Xw,):
                        vi, vj = Y[ii, k], Y[jj, k]
                        Y[ii, k] = torch.where(take, vj, vi)
                        Y[jj, k] = torch.where(take, vi, vj)
                err = full_error(corr)

        if self.verbose:
            print(
                f"Permutation correlator finished: error {float(err):.6f} "
                f"after at most {'inf' if unbounded else self.iters} iterations."
            )
        return Xo if spearman else Xw
