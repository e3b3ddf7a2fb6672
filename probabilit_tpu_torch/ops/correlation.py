"""Correlation induction on sample matrices, in PyTorch.

Port of ``probabilit_tpu/ops/correlation.py``:

* ``ImanConover``: rank-based, marginal-preserving correlation induction
  (Iman & Conover 1982).  ``_apply_rows`` is the four-sort pipeline on a
  (K, N) matrix (sort, scores back to original order, one (K,K)@(K,N)
  product, sort of the recoloured scores and placement of the sorted
  originals); ``_recolor_scores`` is the sort-free Gaussian-copula form
  that generated sampling uses; ``_apply_generated`` the two-sort form
  for pre-sorted marginals.
* ``StudentTCopula``: the same pipeline with the recoloured scores divided
  by a per-observation mixing scale ``sqrt(W / df)``, ``W ~ chi2(df)``
  (the hooks ``_mix_scores``, ``_copula_uniforms``, ``_mix_state`` and
  ``_copula_uniform_row``; identities or the normal CDF in the base).
* ``Cholesky``: exact Pearson induction by whiten-then-colour.
* ``decorrelate``: whitening helper; ``rankdata``: 0-based ranks.

Statistics-bearing products run in full float32: ``_full_float32`` turns
TF32 off around them, as the JAX package pins float32 matmul precision
(``correlation.py:537-541``).  A mixing stream is a ``torch.Generator``
(``w_key``); the JAX package's is a PRNG key.  Under a device mesh of
more than one shard, ``ImanConover._apply_rows`` splits the statistical
columns over the shards (``_apply_rows_sharded``); the other correlators
run on the gathered rows on the mesh's first device.
"""

from __future__ import annotations

import abc
import contextlib

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.ops import sort as _sort
from probabilit_tpu_torch.ops.special import ndtri_fast_wide as ndtri

__all__ = [
    "CorrelatorError",
    "Correlator",
    "Cholesky",
    "ImanConover",
    "StudentTCopula",
    "decorrelate",
    "rankdata",
]


class CorrelatorError(Exception):
    pass


@contextlib.contextmanager
def _full_float32():
    """Run float32 matrix products in full float32 on the card (no TF32:
    it keeps about three decimal digits, which biases the induced
    correlation)."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _is_positive_definite(X):
    try:
        np.linalg.cholesky(np.asarray(X))
        return True
    except np.linalg.LinAlgError:
        return False


def _as_tensor(X):
    """A numpy input goes to ``config.device()`` in the sample dtype; a
    tensor stays where it is."""
    if isinstance(X, torch.Tensor):
        return X
    return torch.as_tensor(np.asarray(X), dtype=config.float_dtype(), device=config.device())


def _sorted_average_ranks(X_sorted):
    """0-based average-tie ranks for each pre-sorted row of ``(K, N)``.

    ``first`` carries each tie run's start index forward, ``last`` its
    end index backward; the average rank is their midpoint.  Ranks carry
    at least float32 (exact integers up to 2^24 rows), float64 inputs keep
    float64.
    """
    K, N = X_sorted.shape
    pos = torch.arange(N, device=X_sorted.device).expand(K, N)
    boundary = X_sorted[:, 1:] != X_sorted[:, :-1]
    edge = torch.ones((K, 1), dtype=torch.bool, device=X_sorted.device)
    starts = torch.cat([edge, boundary], dim=1)
    ends = torch.cat([boundary, edge], dim=1)
    first = torch.cummax(torch.where(starts, pos, -1), dim=1).values
    last = torch.flip(
        torch.cummin(torch.flip(torch.where(ends, pos, N), dims=[1]), dim=1).values,
        dims=[1],
    )
    rank_dtype = torch.promote_types(X_sorted.dtype, torch.float32)
    return (first + last).to(rank_dtype) * 0.5


def rankdata(X, axis=0, method="average"):
    """0-based ranks along ``axis`` (``+ 1`` gives the scipy convention).

    ``method="average"`` gives tied values the mean of their ordinal
    ranks (scipy's ``rankdata``); ``method="ordinal"`` breaks ties by
    position, with a stable sort.
    """
    if method not in ("average", "ordinal"):
        raise ValueError(f"method must be 'average' or 'ordinal', got {method!r}")
    X = _as_tensor(X)
    squeeze = X.ndim == 1
    if squeeze:
        X = X[:, None]
        axis = 0
    XT = X.T if axis == 0 else X
    X_sorted, order = _sort.rowsort_with_order(XT, stable=(method == "ordinal"))
    if method == "ordinal":
        sorted_ranks = torch.arange(XT.shape[1], device=XT.device).expand(XT.shape)
    else:
        sorted_ranks = _sorted_average_ranks(X_sorted)
    ranks = _sort.apply_inverse_permutation_rows(order, sorted_ranks.contiguous())
    ranks = ranks.T if axis == 0 else ranks
    return ranks[:, 0] if squeeze else ranks


def _filler_rows(rows, n, dtype, device):
    """The JAX package's padding rows (``_apply_rows_sharded``): the
    flat index from ``0x9E3779B9`` through a splitmix-style uint32 hash,
    its top 24 bits mapped into (0, 1).  uint32 words are held in int64
    and masked."""
    m32 = 0xFFFFFFFF
    idx = (torch.arange(rows * n, dtype=torch.int64, device=device).reshape(rows, n)
           + 0x9E3779B9) & m32
    h = (idx * 0x85EBCA6B) & m32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & m32
    h = h ^ (h >> 16)
    return (h >> 8).to(dtype) * 2.0**-24 + 2.0**-25


def _triangular_inverse(L):
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


class Correlator(abc.ABC):
    """Protocol: ``correlator.set_target(C)`` then ``X_corr = correlator(X)``.

    ``self.P`` is the lower Cholesky factor of the target (numpy).
    """

    def set_target(self, correlation_matrix):
        C = correlation_matrix
        if not isinstance(C, np.ndarray):
            raise TypeError(
                f"set_target expects a NumPy correlation matrix, got "
                f"{type(C).__name__}."
            )
        if C.ndim != 2:
            raise ValueError(
                f"Target correlation must be a 2-D matrix; got ndim={C.ndim}."
            )
        if C.shape[0] != C.shape[1]:
            raise ValueError(
                f"Target correlation matrix must be square; got shape "
                f"{C.shape}."
            )
        if not np.allclose(np.diag(C), 1.0):
            raise ValueError(
                "Target correlation matrix needs ones on the diagonal."
            )
        if not np.allclose(C.T, C):
            raise ValueError("Target correlation matrix is not symmetric.")
        if not _is_positive_definite(C):
            raise ValueError(
                "Target correlation matrix is not positive definite; "
                "repair it with nearest_correlation_matrix first."
            )

        self.C = C.copy()
        self.P = np.linalg.cholesky(self.C)
        return self

    def _validate_X(self, X, check_rows_cols=True):
        """Check the (observations, variables) sample matrix against the target."""
        if getattr(self, "P", None) is None or getattr(self, "C", None) is None:
            raise CorrelatorError(
                "No target set: call set_target(corr_matrix) before "
                "applying the correlator."
            )
        if not isinstance(X, (np.ndarray, torch.Tensor)):
            raise TypeError(
                f"X must be a NumPy array or a torch tensor, got {type(X).__name__}."
            )
        if X.ndim != 2:
            raise ValueError(
                f"X must be 2-D with shape (observations, variables); got "
                f"ndim={X.ndim}."
            )

        N, K = X.shape
        if self.P.shape[0] != K:
            raise ValueError(
                f"X has {K} columns but the target correlation is "
                f"{self.P.shape[0]}x{self.P.shape[1]}; they must agree."
            )
        if check_rows_cols and N <= K:
            raise ValueError(
                "Inducing correlations needs more observations than "
                f"variables (rows > columns); X has shape {tuple(X.shape)}."
            )
        return N, K

    @abc.abstractmethod
    def _apply(self, X):
        """Core transform: (N, K) tensor -> (N, K) tensor."""

    def _cache_token(self):
        """Hashable identity of the configuration."""
        return type(self).__qualname__

    def __call__(self, X):
        self._validate_X(X)
        return self._apply(_as_tensor(X))


class Cholesky(Correlator):
    """Exact Pearson correlation by whiten-then-colour.

    Preserves each column's mean and standard deviation but NOT the
    marginal shapes.  The whitening factor (empirical Cholesky) and the
    colouring factor (target Cholesky) combine into one K x K matrix, so
    the N-sized work is one product.
    """

    def _apply(self, X):
        with _full_float32():
            N, K = X.shape
            mean = X.mean(dim=0)
            std = X.std(dim=0, unbiased=False)
            X_n = (X - mean) / std
            cov = (X_n.T @ X_n) / N
            P_emp = torch.linalg.cholesky(cov)
            target_P = torch.as_tensor(self.P, dtype=X.dtype, device=X.device)
            transform = torch.linalg.solve_triangular(P_emp.T, target_P.T, upper=True)
            return mean + X_n @ (transform * std)


class ImanConover(Correlator):
    """Marginal-preserving rank correlation induction (Iman-Conover 1982).

    1. van der Waerden scores ``ndtri(rank / (N+1))``;
    2. decorrelate the scores by the Cholesky factor of their empirical
       correlation;
    3. recolour with the target factor ``P`` (2 and 3 are one product);
    4. reorder each original column by the rank of its scored column,
       which keeps the original marginals exactly.

    ``ties="average"`` (default) gives tied values their mean rank, as
    scipy's ``rankdata`` does; ``ties="ordinal"`` breaks ties by position
    (stable sorts).  Score columns are standardised before decorrelation,
    as in the JAX package.
    """

    # The recoloured scores map to uniforms through the normal CDF, so the
    # engine may use the closed-form score shortcuts (ppf.score_emit).
    # Mixed-score subclasses (StudentTCopula) set False and route through
    # _copula_uniforms.
    gaussian_scores = True

    def __init__(self, ties="average"):
        if ties not in ("average", "ordinal"):
            raise ValueError(f"ties must be 'average' or 'ordinal', got {ties!r}")
        self.ties = ties

    def _cache_token(self):
        return (type(self).__qualname__, self.ties)

    def __call__(self, X):
        self._validate_X(X)
        if isinstance(X, np.ndarray):
            # Eager numpy input: the reference's PD guard on rank data.
            XT = torch.as_tensor(X.T, dtype=torch.float32)
            scores, _, _ = self._scores_rows(*self._sort_rows(XT))
            emp = np.corrcoef(scores.numpy(), rowvar=True)
            if not _is_positive_definite(np.atleast_2d(emp)):
                msg = "Rank data correlation not positive definite."
                msg += "There are perfect correlations in the ranked data."
                msg += "Supply more data (rows in X) or sample differently."
                raise ValueError(msg)
        return self._apply(_as_tensor(X))

    def _mix_scores(self, y, w_key=None):
        """Hook between recolouring and rank placement: the identity here
        (the base class is the Gaussian copula)."""
        return y

    def _copula_uniforms(self, y, w_key=None):
        """(K, N) recoloured scores -> correlated uniforms, one score row at
        a time (the JAX package's ``lax.map``): the live state of the
        conversion stays one row."""
        mix = self._mix_state(y.shape[-1], y.dtype, w_key, y.device)
        out = torch.empty_like(y)
        for i in range(y.shape[0]):
            out[i] = self._copula_uniform_row(y[i], mix)
        return out

    def _mix_state(self, n, dtype, w_key=None, device=None):
        """Shared per-observation state of the row-wise conversion: None
        here; StudentTCopula's (n,) mixing scale."""
        return None

    def _copula_uniform_row(self, y_row, mix):
        """One score row -> correlated uniforms, given ``_mix_state``."""
        from probabilit_tpu_torch.ops import special as _special

        return _special.ndtr_fast(y_row)

    def _apply(self, X):
        """Standard (N, K) layout entry; the work is in ``_apply_rows``."""
        return self._apply_rows(X.T).T

    def _sort_rows(self, XT):
        return _sort.rowsort_with_order(XT, stable=(self.ties == "ordinal"))

    def _scores_rows(self, X_sorted, order):
        """(scores, mean, var): van der Waerden scores in original order."""
        K, N = X_sorted.shape
        dtype = X_sorted.dtype
        if self.ties == "average":
            ranks1 = _sorted_average_ranks(X_sorted) + 1.0
            scores_sorted = ndtri(ranks1 / (N + 1))
        else:
            s_row = ndtri(torch.arange(1, N + 1, dtype=dtype, device=X_sorted.device) / (N + 1))
            scores_sorted = s_row.expand(K, N).contiguous()
        scores = _sort.apply_inverse_permutation_rows(order, scores_sorted)
        # Per-row moments from the sorted domain (same multiset per row).
        mean = scores_sorted.mean(dim=1, keepdim=True)
        var = torch.square(scores_sorted - mean).mean(dim=1, keepdim=True)
        return scores, mean, var

    def _apply_rows(self, XT, w_key=None):
        """Iman-Conover on a (K, N) matrix: four sorts (two of them the
        scatters of ``apply_inverse_permutation_rows``) and one product.
        ``w_key`` is the mixing stream of a mixed-score subclass.  Under a
        mesh of more than one shard a Gaussian-score correlator splits the
        rows here (the statistical columns) over the shards
        (``_apply_rows_sharded``)."""
        from probabilit_tpu_torch.parallel import mesh as _mesh

        mesh = _mesh.current_mesh()
        if mesh is not None and mesh.size > 1 and self.gaussian_scores:
            return self._apply_rows_sharded(XT, mesh)
        return self._transform_rows(XT, torch.as_tensor(self.P), w_key=w_key)

    def _apply_rows_sharded(self, XT, mesh):
        """Column-sharded transform: rows padded to a multiple of the shard
        count, each shard's rows sorted, scored, recoloured and placed on
        its own device; the K x K Gram and its factors on the first.

        The filler rows are the JAX package's hashed pseudo-uniforms and
        the target extends block-diagonally.  Cholesky factors and
        triangular inverses respect the order (row block i depends only
        on leading blocks) and the filler carries zero weight for the real
        rows, so the first K output rows are the unsharded result up to
        reduction order: bitwise when the shard count divides K.
        """
        from probabilit_tpu_torch.parallel import mesh as _mesh

        K, N = XT.shape
        home = mesh.devices[0]
        XT = XT.to(home)
        P = np.asarray(self.P)
        K_pad = -(-K // mesh.size) * mesh.size
        if K_pad != K:
            XT = torch.cat([XT, _filler_rows(K_pad - K, N, XT.dtype, home)])
            P_pad = np.eye(K_pad, dtype=P.dtype)
            P_pad[:K, :K] = P
            P = P_pad
        bounds = _mesh.row_bounds(K_pad, mesh.size)
        parts = [self._sort_rows(b) for b in _mesh.split_rows(XT, mesh)]
        scored = [self._scores_rows(x_sorted, order) for x_sorted, order in parts]
        rows = [hi - lo for lo, hi in bounds]
        scores, s_mean, s_var = (
            _mesh.gather_rows([sc[i] for sc in scored], rows, home) for i in range(3)
        )
        with _full_float32():
            gram = (scores @ scores.T) / N
            s_std = torch.sqrt(s_var)
            emp_corr = (gram - s_mean * s_mean.T) / (s_std * s_std.T)
            L = torch.linalg.cholesky(emp_corr)
            M = torch.as_tensor(P).to(dtype=XT.dtype, device=home) @ _triangular_inverse(L)
            Z = (scores - s_mean) / s_std
        out = []
        for (lo, hi), dev, (x_sorted, _) in zip(bounds, mesh.devices, parts):
            with _full_float32():
                correlated = M[lo:hi].to(dev) @ Z.to(dev)
            _, order2 = _sort.rowsort_with_order(correlated)
            out.append(_sort.apply_inverse_permutation_rows(order2, x_sorted))
        return _mesh.gather_rows(out, rows, home)[:K]

    def _transform_rows(self, XT, target_P, w_key=None):
        K, N = XT.shape
        dtype = XT.dtype

        # Steps 1+2: sorted values and order, then tie-resolved scores.
        X_sorted, order = self._sort_rows(XT)
        scores, s_mean, s_var = self._scores_rows(X_sorted, order)

        with _full_float32():
            gram = (scores @ scores.T) / N
            s_std = torch.sqrt(s_var)
            emp_corr = (gram - s_mean * s_mean.T) / (s_std * s_std.T)
            L = torch.linalg.cholesky(emp_corr)
            # Step 3: decorrelate and recolour in one (K,K) @ (K,N) product.
            M = target_P.to(dtype=dtype, device=XT.device) @ _triangular_inverse(L)
            correlated = M @ ((scores - s_mean) / s_std)

        # The elliptical-mixing hook: the identity for the Gaussian copula,
        # a per-observation chi(df)/sqrt(df) division for StudentTCopula.
        correlated = self._mix_scores(correlated, w_key)

        # Step 4: place the sorted originals at the ranks of the scores.
        _, order2 = _sort.rowsort_with_order(correlated)
        return _sort.apply_inverse_permutation_rows(order2, X_sorted)

    def _recolor_scores(self, z):
        """Empirically decorrelate iid normal scores, recolour to target.

        Returns ``y`` of the same (K, N) shape whose rows are standardised
        and whose empirical Pearson correlation is exactly ``self.C``: the
        Iman-Conover score pipeline applied to random normal scores.
        """
        K, N = z.shape
        dtype = z.dtype
        with _full_float32():
            mean = z.mean(dim=1, keepdim=True)
            zc = z - mean
            gram = (zc @ zc.T) / N
            std = torch.sqrt(torch.diagonal(gram))
            emp_corr = gram / torch.outer(std, std)
            L = torch.linalg.cholesky(emp_corr)
            P = torch.as_tensor(self.P, dtype=dtype, device=z.device)
            M = P @ _triangular_inverse(L)
            return M @ (zc / std[:, None])

    def _apply_generated(self, z, x_sorted):
        """Two-sort Iman-Conover for pre-sorted marginals.

        ``z`` (K, N) iid normal scores take the role of the van der
        Waerden scores (the original Iman-Conover formulation with random
        scores); ``x_sorted`` (K, N) holds each variable's values in
        ascending order (``ops/orderstats.sorted_uniforms`` through a
        ppf).  Returns (K, N) correlated samples with exact marginals:
        ``x_sorted`` placed at the ranks of the recoloured (and, for a
        mixed-score subclass, mixed) scores.  The engine uses the
        sort-free form instead; this is kept for direct use.
        """
        correlated = self._mix_scores(self._recolor_scores(z))
        _, order2 = _sort.rowsort_with_order(correlated)
        return _sort.apply_inverse_permutation_rows(order2, x_sorted.to(z.dtype))


class StudentTCopula(ImanConover):
    """Marginal-preserving dependence induction through a Student-t copula.

    Iman-Conover, like every Gaussian-copula method, has no tail
    dependence.  The t copula with ``df`` degrees of freedom keeps the
    elliptical shape matrix but gives the tail dependence ``lambda = 2
    t_{df+1}(-sqrt((df+1)(1-rho)/(1+rho)))``.  The recoloured Gaussian
    scores ``y`` are divided by a per-observation mixing scale
    ``sqrt(W/df)``, ``W ~ chi2(df)``, shared across the K variables (the
    sharing couples the tails); rank placement then restores the exact
    marginals, so only the dependence changes.  Kendall's tau obeys
    ``(2/pi) arcsin(rho)``, as for every elliptical copula.

    ``df``    tail-heaviness of the dependence (not of the marginals).
    ``seed``  seeds the mixing draws when the correlator is applied to a
              plain array (``StudentTCopula(df)(X)``); in the sampling
              engine the mixing stream is keyed by the first correlated
              column's leading quantiles (``engine/compile.py``).
    """

    gaussian_scores = False

    def __init__(self, df=4.0, ties="average", seed=0):
        super().__init__(ties=ties)
        df = float(df)
        if not df > 0.0:
            raise ValueError(f"df must be positive, got {df}.")
        self.df = df
        self.seed = int(seed)

    def _cache_token(self):
        return (type(self).__qualname__, self.df, self.ties, self.seed)

    def _mix_scale(self, n, dtype, w_key=None, device=None):
        """(n,) mixing scales sqrt(W/df), W ~ chi2(df) (``chi2_draws``),
        from ``w_key`` or, without one, a generator seeded ``seed`` on
        ``device``."""
        from probabilit_tpu_torch.ops.special import chi2_draws

        if w_key is None:
            w_key = torch.Generator(device=config.device() if device is None else device)
            w_key.manual_seed(self.seed)
        w = chi2_draws(w_key, self.df, n, dtype, w_key.device)
        return torch.sqrt(w / self.df)

    def _mix_scores(self, y, w_key=None):
        return y / self._mix_scale(y.shape[1], y.dtype, w_key, y.device)[None, :]

    def _mix_state(self, n, dtype, w_key=None, device=None):
        return self._mix_scale(n, dtype, w_key, device)

    def _copula_uniform_row(self, y_row, mix):
        from probabilit_tpu_torch.ops import special as _special

        return _special.t_cdf(y_row / mix, self.df)


def decorrelate(X, remove_variance=True):
    """Remove covariance from X, preserving the mean.

    A numpy input is whitened on the host in its own dtype (float64 in,
    float64 out); a tensor with PyTorch on its device.

    >>> X = np.array([[1. , 1. ],
    ...               [2. , 1.1],
    ...               [2.1, 3. ]])
    >>> np.asarray(np.cov(np.asarray(decorrelate(X)), rowvar=False)).round(6) + 0.0
    array([[1., 0.],
           [0., 1.]])
    """
    if isinstance(X, np.ndarray):
        N = X.shape[0]
        mean = X.mean(axis=0)
        Xc = X - mean
        cov = (Xc.T @ Xc) / (N - 1)
        L = np.linalg.cholesky(cov)
        if not remove_variance:
            L = L / np.sqrt(X.var(axis=0))
        Xw = np.linalg.solve(L, Xc.T).T
        return mean + Xw

    N = X.shape[0]
    mean = X.mean(dim=0)
    var = X.var(dim=0, unbiased=False)
    Xc = X - mean
    with _full_float32():
        cov = (Xc.T @ Xc) / (N - 1)
        L = torch.linalg.cholesky(cov)
        if not remove_variance:
            L = L / torch.sqrt(var)
        Xw = torch.linalg.solve_triangular(L, Xc.T, upper=False).T
    return mean + Xw
