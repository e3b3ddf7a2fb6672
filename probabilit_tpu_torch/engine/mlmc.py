"""Multilevel Monte Carlo estimation of SDE path functionals.

Port of ``probabilit_tpu/engine/mlmc.py``.  Plain Monte Carlo of a
discretised SDE pays O(eps^-2) samples times O(eps^-1) steps for an RMS
accuracy ``eps``; Giles' multilevel estimator (Giles 2008, "Multilevel
Monte Carlo path simulation") telescopes the expectation across a
geometric hierarchy of grids,

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}],

and samples each correction with COUPLED coarse and fine paths driven by
the same Brownian increments: the coarse grid's standard-normal drivers
are the renormalised sums of the fine grid's within each coarse step, so
``Var[P_l - P_{l-1}] -> 0`` with level and most samples run on the
cheapest grids.

A level draws a ``(count, steps_l)`` normal matrix on ``config.device()``
(a ``torch.Generator`` seeded ``_derive_seed(seed, level, start)`` per
block, or with ``method=`` the block's rows of a low-discrepancy
sequence through the Brownian bridge), sums it down to the coarse
drivers, runs both grids through the path node's own
``_increments_from_normals`` and ``_path_from_increments`` (the code the
``SDE`` node and the exact-law families sample with), applies the payoff
and folds four float64 sums on the device, read once per extension of a
level.  Under a device mesh the level's rows are split over the shards,
each shard computes its own payoff differences and their four sums, and
the sums are added on the mesh's first device.  The adaptive outer loop (optimal per-level allocation and the
weak-convergence level test) is host Python on those sums, as in
Giles' algorithm and the JAX package.  The JAX package draws a
fixed-shape masked block under folded keys; the port draws exactly the
rows it needs, so the sums are the same estimator on other bits.

No kernel lies on this path (the JAX package jits its own level program
from ``lax.scan`` code).  The ``SDE`` node's Euler and Milstein schemes
loop over the steps on the host, a few launches a step, so a deep level
is launch-bound (PERF.md §6).

>>> import torch
>>> res = mlmc_estimate(
...     lambda t, x: 0.05 * x, lambda t, x: 0.2 * x,
...     lambda paths: torch.clamp(paths[:, -1] - 100.0, min=0.0),
...     x0=100.0, eps=0.15, random_state=0)          # doctest: +SKIP
>>> bool(abs(res["mean"] - 10.986) < 0.45)          # doctest: +SKIP
True
"""

from __future__ import annotations

import functools
import math
import operator

import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine.streaming import _derive_seed
from probabilit_tpu_torch.parallel import mesh as _mesh

__all__ = ["mlmc_estimate"]


def _level_kernel(make_node, payoff, m0, refine, level, method=None):
    """``(draw, sums, steps_f)`` of one level.

    ``draw(seed, count, start)`` is the level's ``(count, steps_f)``
    standard-normal matrix; ``sums(z)`` the ``(4,)`` float64 device
    tensor ``(sum d, sum d^2, sum P_f, sum P_f^2)`` of a given matrix,
    with ``P_f`` the fine payoff and ``d = P_f - P_c`` (``P_f`` alone at
    level 0).  The coarse drivers are the within-coarse-step sums of
    ``z`` over ``sqrt(refine)``: a sum of ``refine`` iid N(0, 1) over
    sqrt(refine) is the coarse step's exact driver for the same Brownian
    path.  ``make_node(steps)`` builds the path node of a grid: an
    ``SDEPath`` for the callable API, or a node's ``_regrid``.
    """
    steps_f = m0 * refine**level
    fine = make_node(steps_f)
    coarse = None if level == 0 else make_node(steps_f // refine)
    dtype, device = config.float_dtype(), config.device()
    inv_sqrt_r = 1.0 / math.sqrt(refine)

    def draw(seed, count, start):
        if method is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            return torch.randn((count, steps_f), generator=gen, dtype=dtype, device=device)
        # MLQMC (Giles-Waterhouse): the block's rows of a low-discrepancy
        # sequence through the Brownian bridge, so QMC dimension 0 drives
        # the fine path's terminal point.  The bridged z are the physical
        # iid increments, so the coarse coupling below is untouched.
        from probabilit_tpu_torch.ops import bridge as _bridge
        from probabilit_tpu_torch.ops import qmc as _qmc

        u = _qmc.generate(method, seed, count, steps_f, dtype, offset=start, device=device)
        return _bridge.normal_increments(u, dtype)

    def path_payoff(node, z):
        return payoff(node._path_from_increments(node._increments_from_normals(z, dtype)))

    def shard_sums(z):
        pf = path_payoff(fine, z)
        if coarse is None:
            d = pf
        else:
            zc = z.reshape(z.shape[0], steps_f // refine, refine).sum(dim=2) * inv_sqrt_r
            d = pf - path_payoff(coarse, zc)
        d, pf = d.to(torch.float64), pf.to(torch.float64)
        return torch.stack([d.sum(), (d * d).sum(), pf.sum(), (pf * pf).sum()])

    def sums(z):
        # Under a mesh each shard sums its own rows; the four float64
        # sums are added on the mesh's first device.
        mesh = _mesh.current_mesh()
        if mesh is None:
            return shard_sums(z)
        parts = [shard_sums(b).to(mesh.devices[0])
                 for b in _mesh.split_rows(z, mesh) if b.shape[0]]
        return functools.reduce(operator.add, parts)

    return draw, sums, steps_f


class _LevelState:
    """Accumulated per-level sums (host floats) and the level's functions."""

    def __init__(self, draw, sums, steps, cost, rows):
        self.draw = draw
        self.sums = sums
        self.steps = steps
        self.cost = cost  # work units per sample (fine + coarse steps)
        self.rows = rows
        self.n = 0
        self.s1 = 0.0
        self.s2 = 0.0
        self.f1 = 0.0
        self.f2 = 0.0

    def extend(self, seed, level, extra):
        """Add ``extra`` samples in blocks of at most ``rows``; block start
        ``j`` draws from ``_derive_seed(seed, level, j)``.  One host read."""
        done = 0
        acc = None
        while done < extra:
            b = min(self.rows, extra - done)
            start = self.n + done
            part = self.sums(self.draw(_derive_seed(seed, level, start), b, start))
            acc = part if acc is None else acc + part
            done += b
        if acc is not None:
            s1, s2, f1, f2 = acc.tolist()
            self.s1 += s1
            self.s2 += s2
            self.f1 += f1
            self.f2 += f2
        self.n += extra

    @property
    def mean(self):
        return self.s1 / self.n

    @property
    def var(self):
        m = self.mean
        return max(self.s2 / self.n - m * m, 0.0)

    @property
    def fine_var(self):
        m = self.f1 / self.n
        return max(self.f2 / self.n - m * m, 0.0)


def mlmc_estimate(
    drift,
    diffusion=None,
    payoff=None,
    *,
    x0=None,
    T=1.0,
    eps=1e-2,
    m0=4,
    refine=4,
    max_levels=12,
    n_initial=10_000,
    scheme="euler",
    random_state=0,
    block_rows=None,
    method=None,
):
    """Adaptive multilevel Monte Carlo estimate of ``E[payoff(paths)]``.

    Two calling conventions, as in the JAX package:

    ``mlmc_estimate(drift, diffusion, payoff, x0=..., ...)``:
    ``drift``/``diffusion`` follow the ``SDE`` node's contract (callables
    of ``(t, x)`` on torch tensors, elementwise in ``x``).

    ``mlmc_estimate(node, payoff, eps=...)``: ``node`` is an ``SDE`` node
    (its drift, diffusion, x0, T and scheme are used; the hierarchy
    supplies the grids) or an exact-law Gaussian-driven family
    (``GeometricBrownianMotion``, ``BrownianMotion``,
    ``OrnsteinUhlenbeck``), whose levels share bridged drivers with every
    grid carrying the exact marginal law (a terminal payoff's corrections
    are exactly zero).

    ``payoff`` maps an ``(n, steps)`` torch tensor of paths to ``(n,)``
    values with torch ops (where the JAX package's payoff uses jnp), e.g.
    ``lambda p: torch.clamp(p[:, -1] - 100.0, min=0.0)``; it must be
    meaningful on every grid of the hierarchy.

    Runs Giles' adaptive algorithm to RMS accuracy ``eps``: per-level
    counts minimise cost subject to ``sum_l V_l / N_l <= eps^2 / 2``
    (``N_l ~ sqrt(V_l / C_l)``), and levels are appended until
    ``|Y_L| / (refine^alpha - 1) < eps / sqrt(2)`` (``alpha`` the observed
    weak rate, floored at 0.5) or ``max_levels`` is reached.
    ``method="sobol"/"halton"/"antithetic"`` draws each block from a
    low-discrepancy sequence through the Brownian bridge (MLQMC); the
    allocation still treats points as iid.  ``random_state`` is an int.

    Returns a dict: ``mean``, ``eps``, ``levels``, per-level
    ``n_per_level``/``means``/``variances``/``steps``, ``cost`` (total
    step evaluations) and ``cost_mc`` (the projected cost of plain MC at
    the same accuracy on the finest grid).
    """
    from probabilit_tpu_torch.models.processes import PathDistribution
    from probabilit_tpu_torch.models.sde import SDEPath

    if isinstance(drift, PathDistribution):
        node = drift
        if payoff is None:
            payoff = diffusion  # mlmc_estimate(node, payoff, ...)
        if payoff is None:
            raise ValueError(
                "mlmc_estimate(node, payoff, ...): a payoff callable is "
                "required."
            )
        if x0 is not None:
            raise ValueError(
                "x0 comes from the node; do not pass it separately."
            )
        if not isinstance(node, SDEPath):
            # Exact-law coupling: _regrid and _increments_from_normals raise
            # a family-specific error for non-Gaussian-driven nodes.
            dtype = config.float_dtype()
            probe = node._regrid(2)
            probe._increments_from_normals(torch.zeros((1, 2), dtype=dtype), dtype)

        def make_path(steps):
            return node._regrid(steps)

        T = node.T
    else:
        if diffusion is None or payoff is None or x0 is None:
            raise ValueError(
                "mlmc_estimate(drift, diffusion, payoff, x0=...) needs all "
                "of drift, diffusion, payoff and x0 (or pass a path node "
                "as the first argument)."
            )

        def make_path(steps):
            return SDEPath(drift, diffusion, x0=x0, T=T, steps=steps, scheme=scheme)

    if method is not None:
        name = str(method).lower().strip()
        if name == "lhs":
            raise ValueError(
                "method='lhs' stratifies over a FIXED total count, which "
                "adaptive MLMC does not know upfront; use 'sobol', "
                "'halton' or 'antithetic'."
            )
        if name not in ("sobol", "halton", "antithetic"):
            raise ValueError(
                "method must be None, 'sobol', 'halton' or 'antithetic', "
                f"got {method!r}."
            )
        method = name
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}.")
    if refine < 2:
        raise ValueError(f"refine must be >= 2, got {refine}.")
    if m0 < 1:
        raise ValueError(f"m0 must be >= 1, got {m0}.")
    if max_levels < 2:
        raise ValueError(f"max_levels must be >= 2, got {max_levels}.")

    seed = int(random_state)

    def make_level(level):
        steps_f = m0 * refine**level
        # A block holds ~2^22 normals at any depth (16 MB in float32).
        rows = block_rows or max(64, ((1 << 22) // max(steps_f, 1)) // 64 * 64)
        draw, sums, steps_f = _level_kernel(make_path, payoff, m0, refine, level, method=method)
        cost = steps_f + (steps_f // refine if level else 0)
        return _LevelState(draw, sums, steps_f, cost, rows)

    levels = [make_level(0), make_level(1)]
    for lv, st in enumerate(levels):
        st.extend(seed, lv, n_initial)

    target_half = 0.5 * eps * eps  # variance budget: sum V_l / N_l
    for _ in range(200):  # bounded outer loop; every pass adds work
        # Optimal allocation: N_l proportional to sqrt(V_l / C_l).
        lam = sum(math.sqrt(st.var * st.cost) for st in levels) / target_half
        need_more = False
        for lv, st in enumerate(levels):
            n_opt = int(math.ceil(lam * math.sqrt(st.var / st.cost)))
            if n_opt > st.n:
                st.extend(seed, lv, n_opt - st.n)
                need_more = True
        if need_more:
            continue
        # Weak convergence: the observed weak rate from consecutive
        # correction means (level 0 is the full expectation), floored at
        # 0.5 and 1.0 (Euler/Milstein weak order) until two corrections.
        tail = [abs(st.mean) for st in levels[1:]][-3:]
        rates = [
            math.log(a / b) / math.log(refine)
            for a, b in zip(tail[:-1], tail[1:])
            if a > 0 and b > 0
        ]
        alpha = max(0.5, min(rates)) if rates else 1.0
        rem = abs(levels[-1].mean) / (refine**alpha - 1.0)
        if rem < eps / math.sqrt(2.0) or len(levels) >= max_levels:
            break
        levels.append(make_level(len(levels)))
        levels[-1].extend(seed, len(levels) - 1, n_initial)

    total_cost = sum(st.n * st.cost for st in levels)
    # Plain-MC comparator: finest grid, N = 2 Var[P_fine] / eps^2.
    cost_mc = (2.0 * levels[-1].fine_var / (eps * eps)) * levels[-1].steps
    return {
        "mean": sum(st.mean for st in levels),
        "eps": eps,
        "levels": len(levels),
        "n_per_level": [st.n for st in levels],
        "means": [st.mean for st in levels],
        "variances": [st.var for st in levels],
        "steps": [st.steps for st in levels],
        "cost": total_cost,
        "cost_mc": cost_mc,
    }
