"""The plain reference: what a configuration's graph gives for a seed.

Plain PyTorch and NumPy, written from the library's documented semantics
and from the configuration file alone.  It imports nothing of the program
and takes nothing the program made: it draws its own uniforms from the
seed, repairs the target correlation itself, works out each block's
recolouring, evaluates every ppf and transform, and folds the statistics.

* Random stream: sample ``i`` of column ``c`` (the c-th distribution of
  the configuration) is word ``i & 3`` of Philox4x32-10 (Salmon et al.,
  SC'11) at counter ``(g mod 2^32, g >> 32, c, 0)``, ``g = i >> 2``, under
  the key ``(seed mod 2^32, (seed >> 32) mod 2^32)``; its top 23 bits fill
  the mantissa of 1.0f, minus 1, clamped to ``[2^-24, 1 - 2^-24]``.
* A distribution's value is its scipy ppf of that uniform.
* Correlated variables (sort-free Gaussian-copula Iman-Conover): the
  declared target is repaired to the nearest correlation matrix whose
  eigenvalues are at least ``eps`` (Higham 2002, alternating projections
  with Dykstra's correction), and factored ``C = P P^T``.  The scores
  ``z = ndtri(u)`` of the rows that a transform covers give their mean m,
  covariance S and standard deviations s; with ``S / (s s^T) = L L^T``,
  ``y = P L^-1 ((z - m) / s)`` carries the target correlation exactly on
  those rows.  A normal or lognormal variable is ``loc + scale * y`` (or
  ``loc + scale * exp(s y)``); any other is its ppf of ``Phi(y)``, clamped
  to ``[2^-24, 1 - 2^-24]``.  A streamed block's transform covers the
  block's whole ``block_size`` rows, a one-shot call's all of its rows.
* ``estimate``'s statistics: the population variance, ``sem = sqrt(var /
  n)``, and quantiles as the count-weighted mean of the linear order
  statistic of each row of 2^17 samples of each block (a partial last
  block: its whole rows, then its remainder row; with CVaR levels, one
  sort of its valid samples), CVaR as ``v + E[max(X - v, 0)] / (1 - q)``
  on the same rows (Rockafellar-Uryasev).

``Arithmetic("float64")`` is the reference.  ``Arithmetic("bfloat16")``
is the control: the same computation with the uniforms, the scores, the
recoloured scores and every node's value rounded to bfloat16 (its open
unit interval then ends at the largest bfloat16 below 1), and the
statistics folded in float64 as before.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

ROW = 1 << 17  # samples in a row of the quantile estimator
_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def seed_words(seed):
    """The Philox key of an integer seed: its low and its next 32 bits."""
    seed = int(seed)
    return seed & _MASK32, (seed >> 32) & _MASK32


def _mulhilo(m, x):
    # int64 holds 48-bit partial products: split x into 16-bit halves.
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors of 32-bit words (broadcasting)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def uniforms(words, start, n, columns, device):
    """(n, len(columns)) float32 uniforms of samples ``start .. start + n - 1``."""
    first = start // 4
    g = torch.arange(first, -(-(start + n) // 4), dtype=torch.int64, device=device)
    cols = torch.as_tensor(list(columns), dtype=torch.int64, device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    out = philox4x32_10(
        (g & _MASK32)[None], (g >> 32)[None], cols, zero, words[0], words[1]
    )
    bits = torch.stack(out, dim=-1).reshape(len(cols), -1)  # word w is sample 4 g + w
    skip = start - first * 4
    bits = bits[:, skip : skip + n]
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = mantissa.view(torch.float32) - 1.0
    return torch.clamp(u, 2.0**-24, 1.0 - 2.0**-24).T


class Arithmetic:
    """Where the reference rounds: nowhere below float64 (``"float64"``),
    or to bfloat16 at every value (``"bfloat16"``, the control)."""

    def __init__(self, name="float64"):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown arithmetic {name!r}")
        self.name = name
        self.top = 1.0 - 2.0**-24 if name == "float64" else 1.0 - 2.0**-9

    def __call__(self, x):
        x = torch.as_tensor(x)
        if self.name == "float64":
            return x.to(torch.float64)
        return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)

    def unit(self, q):
        """A quantile, rounded, in the open unit interval."""
        return torch.clamp(self(q), 2.0**-24, self.top)


def _ndtri(q):
    return torch.special.ndtri(q.to(torch.float64)).to(q.dtype)


# Each family's standard variate at quantiles q, given its shape parameters
# p; its value is loc + scale * that.
PPFS = {
    "uniform": lambda p, q: q,
    "norm": lambda p, q: _ndtri(q),
    "expon": lambda p, q: -torch.log1p(-q),
    "lognorm": lambda p, q: torch.exp(p["s"] * _ndtri(q)),
    "triang": lambda p, q: torch.where(
        q < p["c"], torch.sqrt(p["c"] * q), 1.0 - torch.sqrt((1.0 - p["c"]) * (1.0 - q))),
}


def _score_value(family, p, y):
    """ppf(Phi(y)) of a normal or lognormal variable, or None."""
    loc, scale = p.get("loc", 0.0), p.get("scale", 1.0)
    if family == "norm":
        return loc + scale * y
    if family == "lognorm":
        return loc + scale * torch.exp(p["s"] * y)
    return None


def _fold(fn):
    def op(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x)
        return out

    return op


TRANSFORMS = {
    "Add": _fold(lambda a, b: a + b),
    "Multiply": _fold(lambda a, b: a * b),
    "Subtract": lambda a, b: a - b,
    "Divide": lambda a, b: a / b,
    "Power": lambda a, b: a**b,
    "Max": _fold(lambda a, b: torch.maximum(torch.as_tensor(a), torch.as_tensor(b))),
    "Min": _fold(lambda a, b: torch.minimum(torch.as_tensor(a), torch.as_tensor(b))),
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Abs": torch.abs,
    "Negate": lambda a: -a,
    "Square": lambda a: a * a,
}


def nearest_correlation(matrix, eps, tol=1e-15, max_iter=100_000):
    """The correlation matrix nearest ``matrix`` in the Frobenius norm whose
    eigenvalues are at least ``eps``: Higham's alternating projections
    with Dykstra's correction, in float64."""
    G = np.asarray(matrix, dtype=np.float64)
    Y, dS = G.copy(), np.zeros_like(G)
    for _ in range(max_iter):
        R = Y - dS
        w, V = np.linalg.eigh((R + R.T) / 2.0)
        X = (V * np.maximum(w, eps)) @ V.T
        dS = X - R
        Y_next = X.copy()
        np.fill_diagonal(Y_next, 1.0)
        step = np.linalg.norm(Y_next - Y)
        Y = Y_next
        if step < tol * np.linalg.norm(Y):
            break
    return (Y + Y.T) / 2.0


class Graph:
    """A configuration's graph, evaluated from uniforms.  A configuration
    whose families or transforms the tables here lack brings them beside
    its file, as ``configs/<name>.py`` with ``PPFS`` and ``TRANSFORMS``."""

    def __init__(self, config):
        self.config = config
        self.ppfs, self.transforms = dict(PPFS), dict(TRANSFORMS)
        extra = Path(__file__).resolve().parent / "configs" / f"{config['name']}.py"
        if extra.is_file():
            spec = importlib.util.spec_from_file_location(f"mcbench_config_{config['name']}", extra)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self.ppfs.update(getattr(module, "PPFS", {}))
            self.transforms.update(getattr(module, "TRANSFORMS", {}))
        self.nodes = config["nodes"]
        self.dists = [node for node in self.nodes if "family" in node]
        self.col = {node["name"]: c for c, node in enumerate(self.dists)}
        corr = config.get("correlation")
        self.corr_vars, self.P = [], None
        if corr:
            order = sorted(range(len(corr["variables"])), key=lambda i: self.col[corr["variables"][i]])
            self.corr_vars = [corr["variables"][i] for i in order]
            target = np.asarray(corr["matrix"], dtype=np.float64)[np.ix_(order, order)]
            repaired = nearest_correlation(target, corr["repair"]["eps"])
            self.P = np.linalg.cholesky(repaired)

    @property
    def d(self):
        return len(self.dists)

    def corr_columns(self):
        return [self.col[name] for name in self.corr_vars]

    def transform(self, words, start, n, device, arith, chunk=1 << 24):
        """(A, b), float64, that recolour the scores of rows ``start ..
        start + n - 1``; None for an uncorrelated graph."""
        if not self.corr_vars:
            return None
        stats = None
        for off in range(0, n, chunk):
            u = uniforms(words, start + off, min(chunk, n - off), self.corr_columns(), device)
            stats = _score_sums(self._scores(u, arith), stats)
        return self._solve(stats, n)

    def _scores(self, u, arith):
        return arith(_ndtri(arith.unit(u).to(torch.float64))).to(torch.float64)

    def _solve(self, stats, n):
        total, gram = stats
        k = len(self.corr_vars)
        mean = total / n
        cov = gram / n - torch.outer(mean, mean)
        std = torch.sqrt(torch.diagonal(cov))
        L = torch.linalg.cholesky(cov / torch.outer(std, std))
        P = torch.as_tensor(self.P, dtype=torch.float64, device=total.device)
        eye = torch.eye(k, dtype=torch.float64, device=total.device)
        A = P @ torch.linalg.solve_triangular(L, eye, upper=False) / std[None, :]
        return A, -A @ mean

    def block(self, words, start, n, cnt, device, arith):
        """A streamed block: the sink's values at samples ``start .. start +
        cnt - 1``, recoloured by the transform of all ``n`` rows of the
        block."""
        u = uniforms(words, start, n, range(self.d), device)
        ab = None
        if self.corr_vars:
            ab = self._solve(_score_sums(self._scores(u[:, self.corr_columns()], arith)), n)
        return self.values(u[:cnt], arith, ab)

    def values(self, u, arith, ab=None):
        """The sink's values at the uniforms ``u`` (n, d), recoloured by ``ab``."""
        vals = {}
        if self.corr_vars:
            A, b = (arith(t).to(torch.float64) for t in ab)
            z = self._scores(u[:, self.corr_columns()], arith)
            y = arith(z @ A.T + b)
            by_name = {node["name"]: node for node in self.dists}
            for i, name in enumerate(self.corr_vars):
                node = by_name[name]
                yi = y[:, i]
                x = _score_value(node["family"], node["params"], yi)
                if x is None:
                    q = arith.unit(torch.special.ndtr(yi.to(torch.float64)))
                    x = self._ppf(node, q)
                vals[name] = arith(x)
        for node in self.nodes:
            name = node["name"]
            if name in vals:
                continue
            if "family" in node:
                q = arith.unit(u[:, self.col[name]])
                vals[name] = arith(self._ppf(node, q))
            else:
                args = [vals[a] if isinstance(a, str) else float(a) for a in node["inputs"]]
                vals[name] = arith(self.transforms[node["op"]](*args))
        return vals[self.config["sink"]]

    def _ppf(self, node, q):
        """scipy's ppf of the node's family and parameters at ``q``."""
        p = node["params"]
        if node["family"] not in self.ppfs:
            raise ValueError(f"the reference has no ppf of {node['family']!r}")
        return p.get("loc", 0.0) + p.get("scale", 1.0) * self.ppfs[node["family"]](p, q)


def _score_sums(z, stats=None):
    """Running (sum of z, sum of z z^T), float64."""
    total, gram = z.sum(dim=0), z.T @ z
    return (total, gram) if stats is None else (stats[0] + total, stats[1] + gram)


def _interp(xs, pos, m, upper):
    """The linear order statistic at rank ``pos`` of the sorted last axis
    (``m`` valid entries, the lower index at most ``upper``)."""
    lo = int(min(max(math.floor(pos), 0), max(upper, 0)))
    frac = pos - lo
    a, b = xs[..., lo], xs[..., min(lo + 1, m - 1)]
    return a + frac * (b - a)


class Fold:
    """``estimate``'s statistics of a stream of blocks, in float64."""

    def __init__(self, size, block_size, quantiles=(), cvar=()):
        self.size, self.block = size, block_size
        self.quantiles, self.cvar = tuple(quantiles), tuple(cvar)
        self.levels = self.quantiles + self.cvar
        self.rows_ok = (
            block_size % ROW == 0 and block_size > ROW
            and all(1.0 / ROW <= q <= 1.0 - 1.0 / ROW for q in self.levels)
        )
        self.parts = []  # (n, sum, M2 about the block's mean, min, max)
        self.qsum = np.zeros(len(self.levels))

    def _order_stats(self, xs, m, upper, weight):
        # xs: (rows, m) sorted; adds each level's row estimates times weight.
        for j, q in enumerate(self.levels):
            v = _interp(xs, q * (m - 1), m, upper)
            if j >= len(self.quantiles):
                tail = (xs - v[:, None]).clamp_min(0.0).sum(dim=-1)
                v = v + tail / (m * (1.0 - q))
            self.qsum[j] += float(v.sum()) * weight

    def add(self, x):
        """Fold one block's valid values (float64, or bfloat16 values held
        in float32)."""
        x = x.to(torch.float64)
        cnt = x.numel()
        mean = x.mean()
        self.parts.append((cnt, float(x.sum()), float(((x - mean) ** 2).sum()),
                           float(x.min()), float(x.max())))
        if not self.levels:
            return
        if self.rows_ok and (cnt == self.block or not self.cvar):
            full = cnt // ROW
            if full:
                rows = torch.sort(x[: full * ROW].reshape(full, ROW), dim=1).values
                self._order_stats(rows, ROW, ROW - 2, ROW)
            rem = cnt - full * ROW
            if rem:
                row = torch.sort(x[full * ROW :]).values[None]
                for j, q in enumerate(self.quantiles):
                    self.qsum[j] += float(_interp(row, q * (rem - 1), rem, ROW - 2)[0]) * rem
            return
        xs = torch.sort(x).values[None]
        self._order_stats(xs, cnt, self.block - 2, cnt)

    def result(self):
        n = sum(p[0] for p in self.parts)
        mean = sum(p[1] for p in self.parts) / n
        m2 = sum(p[2] + p[0] * (p[1] / p[0] - mean) ** 2 for p in self.parts)
        var = m2 / n
        out = {
            "n": n, "mean": mean, "var": var, "std": var**0.5, "sem": (var / n) ** 0.5,
            "min": min(p[3] for p in self.parts), "max": max(p[4] for p in self.parts),
        }
        for j, q in enumerate(self.quantiles):
            out[f"q{q:g}"] = self.qsum[j] / self.size
        for j, q in enumerate(self.cvar):
            out[f"cvar{q:g}"] = self.qsum[len(self.quantiles) + j] / self.size
        return out


def estimate(graph, seed, size, block_size, device, arith, quantiles=(), cvar=()):
    """``estimate(size, random_state=seed, block_size=...)``'s statistics."""
    words = seed_words(seed)
    fold = Fold(size, block_size, quantiles, cvar)
    for b in range(-(-size // block_size)):
        start = b * block_size
        fold.add(graph.block(words, start, block_size, min(block_size, size - start), device,
                             arith))
    return fold.result()


def sample_blocks(graph, seed, size, device, arith, chunk=1 << 24):
    """``sample(size, random_state=seed)``'s values, as (start, values)
    blocks of ``chunk`` rows: one transform over all ``size`` rows."""
    words = seed_words(seed)
    ab = graph.transform(words, 0, size, device, arith)
    for start in range(0, size, chunk):
        u = uniforms(words, start, min(chunk, size - start), range(graph.d), device)
        yield start, graph.values(u, arith, ab)
