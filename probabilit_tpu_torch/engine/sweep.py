"""Scenario sweeps: statistics of one model under S parameter scenarios.

Port of ``probabilit_tpu/engine/sweep.py``.  Stress tests and what-if
ladders evaluate the SAME graph under a grid of parameter values (spot
ladders, vol shocks, rate bumps).  The targeted numeric parameters are
swapped for entries or columns of a ``(S, P)`` tensor (the slot
machinery of ``sensitivity``) and the plain executor
(``engine/compile.py::build_body``) evaluates the graph on
``config.device()``; the statistics stay on the card until one host read
at the end.

The JAX package makes the scenario axis a ``jax.vmap`` over a traced
swap.  ``torch.func.vmap`` refuses what the plain executor does on data
(the Newton tier's convergence loop, the table search, the recolouring's
sorts and solve, host reads of column-keyed nodes), so the port picks one
of two designs by the graph's structure, before any draw (``_batchable``):

* batched: when the scenarios share the quantile matrix and every node
  that depends on a swept slot is one of the five closed-form families
  (``_BATCH_FAMILIES``, with ``Distribution``'s own emit) or an
  arithmetic transform (unary, binary or variadic, not ``NoOp``), and the
  graph declares no correlation, each slot is written as an ``(S, 1)``
  column and one evaluation of the body gives the sink's ``(S, n)``
  values (the nodes off the slots' paths run once, at ``(n,)``), in
  chunks of at most 2^26 values;
* otherwise a loop over the scenarios, one evaluation of the body each
  (every graph the plain executor runs: Newton and table families,
  correlations, path nodes, copulas, independent streams).

On ``mixed_dag_20``'s 64-point price ladder at 2^20 draws, on one H100
80GB HBM3 at 700 W, the batch takes 6.2 ms against the loop's 217 for the
mean, 21 against 295 with q0.95 and cvar0.95 (``tools/torch_sweep_rule.py``;
PERF.md §6).

Common random numbers are the default: every scenario consumes the SAME
quantile matrix, so differences between scenarios are smooth in the
parameters and ladders are monotone where the model is.
``common_random_numbers=False`` gives scenario i a stream of its own,
``_derive_seed(seed, 4, i)`` under the run's seed.  Single-shot sweeps
keep the draw apart from the evaluation (``_build_sweep_fn(...)(theta,
quantiles)``), which is how the tests hold the port to the JAX package
on one matrix.

Streamed sweeps (``block_size=``) draw block b as
``estimate(executor=None)`` does (``_derive_seed(seed, 0, b)``, or the
method's points from ``b * block_size``), so with
``common_random_numbers=True`` scenario s is the estimate of the graph
with its slots set to theta_s, up to the order of float sums.  Their
carries are float64 on the device, where the JAX package carries
float32.  Replicate r draws from ``_derive_seed(seed, 1, r)``, and
round k of replicate r of a sequential sweep from
``_derive_seed(seed, 3, r, k)``, where the JAX package folds keys.

No kernel lies on this path: K1 (``engine/cuda_exec.py``) bakes
parameters into its text, and the JAX package's sweep also runs its
plain body, never its TPU kernel.  R2 of the JAX package (an explicit
``max_size`` capped at 64 rounds) is fixed: ``max_size // size`` rounds.

Under a device mesh and common random numbers the quantile matrix is
split by rows, each shard evaluates its rows of every scenario, and the
row statistics are computed on the mesh's first device; without common
random numbers nothing is sharded, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as _compile
from probabilit_tpu_torch.engine import streaming as _streaming
from probabilit_tpu_torch.engine.sampler import resolve_seed
from probabilit_tpu_torch.engine.sensitivity import (
    _QMC_METHODS,
    _normalize_wrt,
    _resolve_statistic,
    _restore_slots,
    _save_slots,
    _swapped,
    _write_slot,
)
from probabilit_tpu_torch.ops import qmc as _qmc

__all__ = ["sweep", "SweepResult"]

_SCENARIO_STREAM = 4  # _derive_seed path of scenario i's own stream: (4, i)
# The families whose ppf is elementwise arithmetic in every parameter
# (ops/ppf.py), so an (S, 1) or (S, n) parameter broadcasts.
_BATCH_FAMILIES = frozenset({"uniform", "norm", "triang", "lognorm", "expon"})
_BATCH_ELEMENTS = 1 << 26  # scenarios x draws of one batched evaluation


class SweepResult:
    """Per-scenario statistics, keyed by statistic name.

    ``result["mean"]`` is the ``(S,)`` array of scenario means in input
    order; ``result.scenarios`` maps each ``(node, slot)`` pair to its
    ``(S,)`` value vector; ``result.n`` is the scenario count.  When
    ``"mean"`` is among the requested statistics, ``result["sem"]`` holds
    each scenario's iid standard error (under CRN, scenario DIFFERENCES
    are far more accurate than these marginal bars suggest).  Under
    ``method="sobol"/"halton"/"lhs"`` the iid formula is not a valid
    error bar and ``"sem"`` is omitted unless ``replicates=`` supplies
    the between-replicate estimate (``"antithetic"`` keeps the iid sem
    as a conservative overestimate).
    """

    def __init__(self, stats, scenarios, size):
        self.stats = stats
        self.scenarios = scenarios
        self.n = len(next(iter(scenarios.values())))
        self.size = size

    def __getitem__(self, key):
        return self.stats[key]

    def keys(self):
        return self.stats.keys()

    def __repr__(self):
        names = ", ".join(self.stats)
        return (
            f"SweepResult({self.n} scenarios x {self.size} draws; "
            f"statistics: {names})"
        )


def _normalize_scenarios(plan, scenarios):
    """-> (pairs in canonical order, (S, P) float64 value matrix)."""
    if not isinstance(scenarios, dict) or not scenarios:
        raise ValueError(
            "scenarios must be a non-empty dict: {(node, slot): values} "
            "or {node: {slot: values}}."
        )
    flat = {}

    def put(pair, vals):
        # The two key forms can name the same parameter; letting the later
        # entry win would sweep other values than the user wrote down.
        if pair in flat:
            raise ValueError(
                f"scenario parameter {pair} is specified more than once "
                "(mixing the (node, slot) and {node: {slot: ...}} forms?)."
            )
        flat[pair] = vals

    for k, v in scenarios.items():
        if isinstance(k, tuple) and len(k) == 2:
            put(k, v)
        elif isinstance(v, dict):
            for slot, vals in v.items():
                put((k, slot), vals)
        else:
            raise ValueError(
                "scenario keys must be (node, slot) tuples, or node keys "
                "with {slot: values} dict values; got "
                f"{type(k).__name__}: {type(v).__name__}."
            )
    wrt = {}
    for node, slot in flat:
        wrt.setdefault(node, []).append(slot)
    pairs = _normalize_wrt(plan, wrt)  # validates nodes/slots, canonical order
    cols, lengths = [], set()
    for pair in pairs:
        vals = np.atleast_1d(np.asarray(flat[pair], np.float64))
        if vals.ndim != 1:
            raise ValueError(
                f"scenario values for {pair} must be scalar or 1-D, got "
                f"shape {vals.shape}."
            )
        if not np.all(np.isfinite(vals)):
            raise ValueError(f"scenario values for {pair} contain non-finite entries.")
        cols.append(vals)
        if vals.size > 1:
            lengths.add(vals.size)
    if len(lengths) > 1:
        raise ValueError(
            f"scenario value vectors disagree on length: {sorted(lengths)}. "
            "Broadcast your grid first (np.meshgrid(...) then .ravel())."
        )
    s = lengths.pop() if lengths else 1
    theta = np.stack([np.broadcast_to(c, (s,)) for c in cols], axis=1)
    return pairs, theta


def sweep(
    sink,
    scenarios,
    size=65536,
    random_state=None,
    statistics="mean",
    correlator="imanconover",
    method=None,
    common_random_numbers=True,
    block_size=None,
    replicates=None,
    target_sem=None,
    max_size=None,
):
    """Evaluate statistics of ``sink`` under S parameter scenarios.

    The JAX package's ``sweep`` documents each argument; the port keeps
    its contract, on ``config.device()`` through the plain executor:

    * ``scenarios``: ``{(node, slot): values}`` or ``{node: {slot:
      values}}``, each ``values`` a length-S vector (scalars broadcast);
      the slots ``sensitivity()`` accepts, indexed joint slots
      (``"s0[1]"``) included.  For a grid, ravel a meshgrid.
    * ``statistics``: any mix of ``"mean"``, ``"var"``, ``"std"``,
      ``"q<level>"``, ``"cvar<level>"`` or callables of the ``(size,)``
      sample tensor (torch ops).  ``"mean"`` brings a per-scenario
      ``"sem"``, except under ``method="sobol"/"halton"/"lhs"`` without
      ``replicates=``.
    * ``method=``: a QMC or antithetic matrix; streamed QMC needs a
      correlation-free graph.  ``common_random_numbers=False``: each
      scenario its own stream.
    * ``block_size=``: streamed sweeps at any ``size`` for named
      statistics (exact Chan folds of mean and var; ``q``/``cvar`` by the
      row sorts of ``estimate(quantiles=...)``, one row per block and
      scenario); var is ``M2 / (n - 1)`` there, as in the JAX package.
    * ``replicates=R``: R streams, each CRN across scenarios; every
      statistic gains ``name + "_sem"``.  ``target_sem=`` (with
      ``replicates``) adds rounds of ``size`` draws until every
      statistic's replicate sem is within it or ``max_size`` draws a
      scenario are spent (default ``64 * size``; an explicit ``max_size``
      allows ``max_size // size`` rounds); the result gains ``rounds``
      and ``converged``.

    Returns a ``SweepResult``: ``result[name]`` is an ``(S,)`` numpy
    array in scenario order.

    >>> import numpy as np, probabilit_tpu_torch as pt
    >>> x = pt.Distribution("norm", loc=0.0, scale=1.0)
    >>> res = pt.sweep(2.0 * x + 1.0, {(x, "loc"): np.array([-1.0, 0.0, 1.0])},
    ...                size=4096, random_state=0)   # doctest: +SKIP
    >>> bool(np.all(np.diff(res["mean"]) > 0))      # doctest: +SKIP
    True
    """
    plan = _compile.get_plan(sink)
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The swept node produces host-finalized (non-numeric) output; "
            "sweeps need a numeric sink."
        )
    pairs, theta_np = _normalize_scenarios(plan, scenarios)
    size = int(size)
    if size <= max(1, len(plan.corr_vars)):
        raise ValueError(f"size={size} is too small to estimate a statistic.")

    if isinstance(statistics, str) or callable(statistics):
        statistics = (statistics,)
    stat_keys = [_resolve_statistic(s)[1] for s in statistics]
    names = [k if isinstance(k, str) else f"stat{i}" for i, k in enumerate(stat_keys)]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate statistics requested: {names}.")

    method_name = None if method is None else str(method).lower().strip()
    # The iid sem is no valid error bar for low-discrepancy points, so it
    # is omitted for them; for "antithetic" it is a conservative bar.
    with_sem = "mean" in names and method_name not in ("sobol", "halton", "lhs")
    if method_name is not None:
        if method_name not in _QMC_METHODS:
            raise ValueError(
                f"method must be one of {_QMC_METHODS} or None, got "
                f"{method!r}."
            )
        seeded = _compile.find_key_seeded(plan)
        if seeded is not None:
            raise ValueError(
                f"method={method!r} drives the run from an explicit "
                f"quantile matrix, but {seeded!r} draws from a "
                "column-seeded PRNG key; use method=None for this graph."
            )
        if plan.corr_matrix is not None and block_size is not None:
            raise ValueError(
                "Streamed QMC sweeps require a correlation-free graph; "
                "use method=None for streamed correlated sweeps or drop "
                "block_size=."
            )

    correlator_cls = _compile.resolve_correlator(correlator)
    dtype, device = config.float_dtype(), config.device()
    crn = bool(common_random_numbers)
    seed = resolve_seed(random_state)
    theta = torch.as_tensor(theta_np, dtype=dtype, device=device)

    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream "
                "has no between-replicate variance to estimate sems from."
            )
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps})."
            )
        sub = size // reps
    else:
        reps, sub = None, size
    inner_sem = with_sem and reps is None

    if target_sem is not None:
        if not (float(target_sem) > 0.0):
            raise ValueError(f"target_sem must be > 0, got {target_sem}.")
        if reps is None:
            raise ValueError(
                "target_sem needs replicates=R (e.g. replicates=8): the "
                "between-replicate sem of R independently randomised CRN "
                "streams is the stopping statistic that stays valid for "
                "every statistic and every method= (including QMC)."
            )
        if any(not isinstance(k, str) for k in stat_keys):
            raise ValueError(
                "target_sem supports named statistics only ('mean'/'var'/"
                "'std'/'q<level>'/'cvar<level>'): sequential rounds pool "
                "by averaging equal-size round estimates, which a "
                "callable's statistic need not permit."
            )
        max_size = 64 * size if max_size is None else int(max_size)
        if max_size < size:
            raise ValueError(
                f"max_size ({max_size}) must be >= the per-round size "
                f"({size})."
            )
    elif max_size is not None:
        raise ValueError("max_size= only applies with target_sem=.")

    if block_size is not None:
        block_size = int(block_size)
        if plan.corr_matrix is not None and not _compile.recolor_eligible(plan, correlator_cls):
            raise ValueError(
                "Streamed sweeps on a correlated graph need the generated "
                "sort-free recoloring (ImanConover/StudentTCopula over "
                "monotone inverse-CDF variables); drop block_size= for "
                "the single-shot correlated program."
            )
        q_levels, cvar_levels = [], []
        for k in stat_keys:
            if not isinstance(k, str):
                raise ValueError(
                    "Streamed sweeps (block_size=) support named "
                    "statistics only ('mean'/'var'/'std'/'q<level>'/"
                    "'cvar<level>'); a callable needs the full sample "
                    "vector — drop block_size for it."
                )
            if k in ("mean", "var", "std"):
                continue
            if k.startswith("cvar"):
                cvar_levels.append(float(k[4:]))
            else:  # validated by _resolve_statistic: q<level>
                q_levels.append(float(k[1:]))
        q_levels, cvar_levels = tuple(q_levels), tuple(cvar_levels)
        lhs_total = sub if method_name == "lhs" else None
        n_blocks = -(-sub // block_size)
        last_count = sub - (n_blocks - 1) * block_size
        run = _build_stream_sweep_fn(
            plan, pairs, block_size, method_name, lhs_total, correlator_cls, crn,
            q_levels, cvar_levels,
        )

        def run_stats(s):
            n_, mean_, var_, tails_ = run(theta, s, n_blocks, last_count)
            cols = {}
            for name in names:
                if name == "mean":
                    cols[name] = mean_
                elif name == "var":
                    cols[name] = var_
                elif name == "std":
                    cols[name] = np.sqrt(var_)
                elif name.startswith("cvar"):
                    cols[name] = tails_[:, len(q_levels) + cvar_levels.index(float(name[4:]))]
                else:
                    cols[name] = tails_[:, q_levels.index(float(name[1:]))]
            if inner_sem:
                cols["sem"] = np.sqrt(var_ / n_)
            return cols

    else:
        drawn = method_name is None
        run = _build_sweep_fn(plan, pairs, statistics, inner_sem, correlator_cls, drawn, crn)
        width = plan.d if drawn else plan.d_total

        def draw(s):
            return _qmc.generate(method_name, s, sub, width, dtype, device=device)

        def run_stats(s):
            if crn:
                out = run(theta, draw(s))
            else:
                out = np.concatenate(
                    [
                        run(theta[i : i + 1], draw(_streaming._derive_seed(s, _SCENARIO_STREAM, i)))
                        for i in range(theta.shape[0])
                    ],
                    axis=1,
                )
            return dict(zip(names + (["sem"] if inner_sem else []), out))

    seq_rounds, seq_converged = None, None
    if target_sem is not None:
        # Rounds of R replicate streams (each CRN across scenarios), pooled
        # per replicate by plain averaging: exact for mean and var over
        # equal-size rounds, and the round-averaged estimator the streamed
        # path uses for quantiles and cvar.  Chow-Robbins on the worst
        # statistic column decides how many rounds to add.
        per = [[] for _ in range(reps)]
        rounds_done, add = 0, 1
        max_rounds = max_size // size  # R2 fixed: the JAX package caps this at 64
        while True:
            for _ in range(add):
                for r in range(reps):
                    per[r].append(run_stats(_streaming._derive_seed(seed, 3, r, rounds_done)))
                rounds_done += 1
            rep_cols = [
                {name: np.mean(np.stack([d[name] for d in lst]), axis=0) for name in lst[0]}
                for lst in per
            ]
            stats = {}
            worst = 0.0
            for name in rep_cols[0]:
                arr = np.stack([c[name] for c in rep_cols])
                stats[name] = arr.mean(axis=0)
                sem_col = arr.std(axis=0, ddof=1) / np.sqrt(reps)
                stats[name + "_sem"] = sem_col
                if np.all(np.isfinite(sem_col)):
                    worst = max(worst, float(sem_col.max()) / float(target_sem))
                else:
                    worst = np.inf
            if "mean" in stats:
                stats["sem"] = stats["mean_sem"]
            converged = bool(np.isfinite(worst) and worst <= 1.0)
            if converged or rounds_done >= max_rounds:
                break
            if np.isfinite(worst) and worst > 0.0:
                need = rounds_done * worst * worst * 1.2 - rounds_done
            else:
                need = rounds_done
            add = max(int(min(max(need, 1.0), 3.0 * rounds_done, max_rounds - rounds_done)), 1)
        seq_rounds, seq_converged = rounds_done, converged
        size = size * rounds_done  # per-scenario total actually drawn
    elif reps is None:
        stats = run_stats(seed)
    else:
        # R independently randomised streams, each CRN across scenarios:
        # the between-replicate spread is the valid error bar for every
        # statistic under any method.
        per = [run_stats(_streaming._derive_seed(seed, 1, r)) for r in range(reps)]
        stats = {}
        for name in per[0]:
            arr = np.stack([p[name] for p in per])
            stats[name] = arr.mean(axis=0)
            stats[name + "_sem"] = arr.std(axis=0, ddof=1) / np.sqrt(reps)
        if "mean" in stats:
            stats["sem"] = stats["mean_sem"]
    bad = {k: v for k, v in stats.items() if not np.all(np.isfinite(v))}
    if bad:
        raise FloatingPointError(
            "Non-finite sweep statistics for "
            f"{sorted(bad)}; a scenario pushed a parameter outside its "
            "family's valid domain (e.g. a non-positive scale)."
        )
    res = SweepResult(
        stats,
        {pair: theta_np[:, j].copy() for j, pair in enumerate(pairs)},
        size,
    )
    if seq_rounds is not None:
        res.rounds = seq_rounds
        res.converged = seq_converged
    return res


def _batchable(plan, pairs, crn):
    """Does one batched evaluation give every scenario (module docstring)?

    Decided by the graph's structure alone: the scenarios share one
    quantile matrix, the graph declares no correlation, and every node
    downstream of a swept slot (the slots' own nodes included) is a plain
    ``Distribution`` of ``_BATCH_FAMILIES`` or an arithmetic transform.
    """
    from probabilit_tpu_torch.models import graph as _graph
    from probabilit_tpu_torch.models.distributions import Distribution

    if not crn or plan.corr_matrix is not None:
        return False
    tainted = {node._id for node, _ in pairs}
    for node in plan.topo:
        if node._id not in tainted and not any(p._id in tainted for p in node.get_parents()):
            continue
        tainted.add(node._id)
        if type(node) is Distribution:
            if node.distr not in _BATCH_FAMILIES:
                return False
        elif isinstance(node, _graph.NoOp) or not isinstance(
            node, (_graph.UnaryTransform, _graph.BinaryTransform, _graph.VariadicTransform)
        ):
            return False
    return True


def _check_real(samples):
    if not samples.is_floating_point():
        raise ValueError(
            "The swept node is integer-valued; cast it "
            "(node * 1.0) to sweep real-valued statistics."
        )
    return samples


def _scenario_rows(body, plan, pairs, theta, quantiles, batched, drawn=False, shard=False):
    """Yield the sink's samples under the rows of ``theta``, in order, as
    ``(s, n)`` tensors: one evaluation of the body per chunk of scenarios
    (each slot an ``(s, 1)`` column), or one per scenario (``(1, n)``).

    ``shard`` (common random numbers) splits the matrix's rows over the
    active mesh: each shard evaluates its own rows with the slot values on
    its device, and the rows are gathered on the first device along the
    sample axis (``compile.map_quantiles``)."""
    sink_id = plan.sink._id

    def rows(one):
        if shard:
            return _compile.map_quantiles(plan, one, quantiles, drawn, axis=-1)
        return one(quantiles)

    if not batched:
        for th in theta:
            y = rows(lambda q, th=th: _swapped(pairs, th.to(q.device), lambda: body(q)[sink_id]))
            yield _check_real(y)[None]
        return
    n = sum(q.shape[0] for q in quantiles) if isinstance(quantiles, tuple) else quantiles.shape[0]
    chunk = max(1, _BATCH_ELEMENTS // max(n, 1))
    for lo in range(0, theta.shape[0], chunk):
        cols = theta[lo : lo + chunk]

        def one(q, cols=cols):
            saved = _save_slots(pairs)
            try:
                for (node, slot), col in zip(pairs, cols.to(q.device).T):
                    _write_slot(node, slot, col[:, None])
                return body(q)[sink_id]
            finally:
                _restore_slots(saved)

        yield _check_real(rows(one)).expand(cols.shape[0], n)


def _sweep_body(plan, correlator_cls, drawn):
    """The plain executor's body of the sink, on drawn uniforms (the
    sort-free recolouring where ``recolor_eligible`` allows) or on an
    explicit matrix (the correlator's transform, path nodes' slabs)."""
    generated = (
        drawn and plan.corr_matrix is not None and _compile.recolor_eligible(plan, correlator_cls)
    )
    return _compile.build_body(
        plan, {plan.sink._id}, correlator_cls, generated=generated, drawn=drawn
    )


def _row_statistics(statistics, with_sem):
    """``stats(rows) -> (K, S)`` of an ``(S, n)`` sample tensor: the named
    statistics along the rows in one call each (``sensitivity``'s
    ``_quantile`` and ``_cvar`` take the last axis), a callable row by
    row, then the iid sem when ``with_sem`` (``std(ddof=1) / sqrt(n)`` in
    the samples' float type)."""
    resolved = [_resolve_statistic(s) for s in statistics]

    def stats(rows):
        n = rows.shape[-1]
        out = []
        for fn, key in resolved:
            if key == "mean":
                out.append(rows.mean(dim=-1))
            elif key in ("var", "std"):
                out.append(getattr(rows, key)(dim=-1, correction=1))
            elif isinstance(key, str):
                out.append(fn(rows))
            else:
                out.append(torch.stack([torch.as_tensor(fn(r), device=r.device).reshape(())
                                        for r in rows]))
        if with_sem:
            root = torch.sqrt(torch.tensor(float(n), dtype=rows.dtype))
            out.append(rows.std(dim=-1, correction=1) / root.to(rows.device))
        return torch.stack([v.to(torch.float64) for v in out])

    return stats


def _build_sweep_fn(plan, pairs, statistics, with_sem, correlator_cls, drawn, crn=True):
    """``run(theta (S, P), quantiles) -> (K, S)`` float64 numpy statistics.

    ``quantiles`` is one matrix every scenario consumes: the ``(n,
    plan.d)`` uniforms the engine drew (``drawn=True``) or an explicit
    ``(n, plan.d_total)`` matrix.  Row k of the result is
    ``statistics[k]`` (a name or a callable, as ``sweep`` takes them) over
    the scenarios, then the iid sem when ``with_sem``.  The scenario axis
    follows ``_batchable``; the statistics stay on the device until one
    host read.
    """
    body = _sweep_body(plan, correlator_cls, drawn)
    batched = _batchable(plan, pairs, True)
    stats = _row_statistics(statistics, with_sem)

    def run(theta, quantiles):
        rows = _scenario_rows(body, plan, pairs, theta, quantiles, batched, drawn, crn)
        return torch.cat([stats(y) for y in rows], dim=1).cpu().numpy()

    return run


def _build_stream_sweep_fn(
    plan, pairs, block_size, method_name, lhs_total, correlator_cls, crn, q_levels, cvar_levels,
):
    """``run(theta (S, P), seed, n_blocks, last_count) -> (n, mean (S,),
    var (S,), tails (S, L))`` as float64 numpy, ``L = len(q_levels) +
    len(cvar_levels)``.

    Each block evaluates every scenario on the same draws (CRN; batched
    where ``_batchable`` allows), or on scenario i's stream
    ``_derive_seed(seed, 4, i)``.  Each chunk of scenarios
    (``_scenario_rows``: at most ``_BATCH_ELEMENTS`` values, or one
    scenario) is folded as it comes, so memory stays one chunk's whatever
    S and the block: its float32 rows' moments are ``estimate()``'s
    (``streaming._block_moments``), Chan-merged in float64 on the device,
    and quantile and CVaR levels ride one batched row sort
    (``_quantile_accumulators_many``, the scenario axis playing the node
    axis).
    """
    drawn = method_name is None
    body = _sweep_body(plan, correlator_cls, drawn)
    batched = _batchable(plan, pairs, crn)
    qacc_full, qacc_partial = _streaming._quantile_accumulators_many(
        q_levels, block_size, cvar_levels
    )
    dtype, device = config.float_dtype(), config.device()

    def block_quantiles(seed, b):
        if drawn:
            return _qmc.uniform(_streaming._derive_seed(seed, 0, b), block_size, plan.d, dtype,
                                device)
        return _qmc.generate(
            method_name, seed, block_size, plan.d_total, dtype, offset=b * block_size,
            total=lhs_total, device=device,
        )

    def block_rows(theta, seed, b):
        if crn:
            return _scenario_rows(
                body, plan, pairs, theta, block_quantiles(seed, b), batched, drawn, True
            )
        return (
            next(_scenario_rows(
                body, plan, pairs, theta[i : i + 1],
                block_quantiles(_streaming._derive_seed(seed, _SCENARIO_STREAM, i), b), False,
            ))
            for i in range(theta.shape[0])
        )

    def block_stats(y, cnt):
        y = y.to(torch.float32)
        bn, bm, bm2 = _streaming._block_moments(y, None, cnt, False, False)[:3]
        return bn, bm, bm2, qacc_full(y) if cnt == block_size else qacc_partial(y, cnt)

    def run(theta, seed, n_blocks, last_count):
        f64 = torch.float64
        s = theta.shape[0]
        n = torch.zeros((), dtype=f64, device=device)
        mean = torch.zeros((s,), dtype=f64, device=device)
        m2 = torch.zeros((s,), dtype=f64, device=device)
        qsum = torch.zeros((s, len(q_levels) + len(cvar_levels)), dtype=f64, device=device)
        for b in range(n_blocks):
            cnt = last_count if b == n_blocks - 1 else block_size
            parts = [block_stats(y, cnt) for y in block_rows(theta, seed, b)]
            bn = parts[0][0]
            bm, bm2, bq = (torch.cat([p[k] for p in parts]) for k in (1, 2, 3))
            nn = n + bn
            delta = bm - mean
            mean = mean + delta * bn / nn
            m2 = m2 + bm2 + delta * delta * (n * bn / nn)
            qsum = qsum + bq
            n = nn
        n, mean, m2, qsum = (_streaming._host(v).astype(np.float64) for v in (n, mean, m2, qsum))
        return float(n), mean, m2 / (n - 1.0), qsum / n

    return run
