"""Block-streamed sampling and streaming Monte Carlo estimates.

Port of the core of ``probabilit_tpu/engine/streaming.py``: the sample
axis is cut into blocks, each block is sampled on its own, and either

* copied to the host (``sample_streaming``): full sample vectors of any
  size with device memory bounded by one block; or
* folded into a running reduction (``estimate``): mean, var, min, max,
  skew and kurtosis, quantiles, CVaR, histograms, conditional
  (``where=``) and control-variate estimates at 1e9+ draws.

``executor="auto"`` samples each block with the CUDA megakernel
(``engine/cuda_exec.py``) wherever the JAX package picks its TPU
megakernel: the graph is supported and the correlator is exact
Iman-Conover (or the graph is uncorrelated).  Block b draws samples
``[b*B, b*B + B)`` of the seed's one Philox stream (the kernels'
``start``), so an uncorrelated ``sample_streaming(executor="cuda")``
equals ``sample(executor="cuda")`` bit for bit.  A correlated graph is
recoloured per block from that block's own statistics (K2, then the
K x K solve on the device), so every block carries the target
correlation, as in the JAX package.  ``executor=None`` draws each block
from a ``torch.Generator`` seeded from ``(seed, b)`` and runs the plain
executor.

The carry stays on the device: Chan/Pébay merges in float64 on device
scalars (the JAX package carries float32), on the card one launch of
the fold kernel a block (``csrc/block_fold.cu``) into one float64
buffer of the moment fields, histogram counts in int64
(where the JAX package splits each count over two float32 words), and
the non-finite flag as a device boolean read once, at the end.  Nothing
waits for the card between blocks.  Under a ``torch.profiler`` session a
call of ``estimate`` records the ``probabilit.estimate`` span, each
block's fold a ``probabilit.fold`` span and the carry's read a
``probabilit.wait`` span (``utils/profiling.span``).

``estimate`` also runs sequentially to a target precision
(``target_sem``/``target_rel_sem`` up to ``max_size``, alone or with
``replicates``) and resumably (``checkpoint=``, ``checkpoint_every=``),
as the JAX package does.  Each sequential round, and each replicate of
each round, draws from its own seed, ``_derive_seed(seed, 2, round)`` and
``_derive_seed(seed, 3, replicate, round)``: on the kernels, block b of a
seed is samples b*B.. of that seed's one Philox stream, so two rounds
under one seed would draw the same samples.  Every round reuses the one
tape and build (sizes are arguments, not structure).  A checkpointed run
is cut into segments of whole blocks at fixed boundaries; each segment's
carry is saved as it completes, and a rerun with the same arguments
resumes and gives bitwise the result of the uninterrupted checkpointed
run.  Unlike the JAX package, ``checkpoint=`` needs an explicit
``random_state`` (fresh entropy could never resume: ROADMAP C, R3).

``method="sobol"/"halton"/"lhs"/"antithetic"`` streams one long point
sequence on the plain executor: block b generates points ``[b*B, b*B +
B)`` (``ops/qmc.generate``'s ``offset``; LHS stratifies over the whole
run), so ``sample_streaming(method=m)`` equals ``sample(method=m)`` bit
for bit.  As in the JAX package, a streamed method refuses a correlated
graph (recolouring per block cannot equal one run) and a graph with a
column-seeded node (a copula or multivariate node, whose per-block draws
differ from the one-shot column's), and ``executor="cuda"`` refuses a
method (the kernel draws its own stream).  Replicated runs re-randomise
each replicate from ``_derive_seed(seed, 1, r)``; under a QMC method the
sequential stopping rule needs ``replicates``.

``estimate_many`` folds several nodes from the same joint draws: the
nodes (with a control or condition) are rooted under one cached ``NoOp``,
whose plan fixes the column layout, and each block is folded into
(M,)-vector carries, with one batched row sort a block for every node's
quantiles and CVaR and, with ``covariance=True``, the (M, M) co-moment
sums.  The kernels refuse a ``NoOp`` sink, as the TPU kernel does, so its
blocks run on the plain executor on ``config.device()``.  Every option of
``estimate`` composes, with the JAX package's rules and messages.

Under a device mesh (``parallel/mesh.py``) each block's rows are split
over the shards (``compile.map_quantiles``; a method's rows generated
shard by shard) and the fold runs on ``mesh.devices[0]``, so a fixed-size
estimate equals the one without a mesh bit for bit.  ``executor="auto"``
takes the plain executor under a mesh, and ``executor="cuda"`` refuses
it.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import checkpoint as _checkpoint
from probabilit_tpu_torch.engine import compile as _compile
from probabilit_tpu_torch.engine.sampler import cuda_limits, resolve_seed
from probabilit_tpu_torch.ops import qmc as _qmc
from probabilit_tpu_torch.parallel import mesh as _mesh
from probabilit_tpu_torch.utils import profiling as _profiling

__all__ = ["sample_streaming", "estimate", "estimate_many"]

_ROW = 1 << 17  # columns of the quantile estimator's row sorts
# Where a correlated block's K x K recolour system is solved
# (``cuda_exec.recolor_transform``'s ``solve``): "device" never waits
# between blocks, "host" syncs once per block.  ``chip_smoke.py`` phase 12
# times both; on an H100 the streamed estimate is faster with "device",
# while a one-shot ``sample`` is faster solving on the host (phase 10).
RECOLOR_SOLVE = "device"
_HISTOGRAM_MAX_BINS = 512
_MAX_ROUNDS = 64  # a sequential run stops after this many rounds
_SEGMENT_BLOCKS = 64  # blocks a checkpointed segment holds by default
_STREAMED_METHODS = ("sobol", "halton", "lhs", "antithetic")


def _derive_seed(seed, *path):
    """A 64-bit seed for the stream ``path`` under ``seed`` (numpy's
    SeedSequence spawn keys: independent for distinct paths)."""
    words = np.random.SeedSequence(seed % 2**64, spawn_key=path).generate_state(2, np.uint32)
    return int(words[0]) | int(words[1]) << 32


# ---------------------------------------------------------------------
# Per-block accumulators
# ---------------------------------------------------------------------


def _interp(xs, pos, m, upper):
    """np.quantile's 'linear' order statistic at rank ``pos`` of the sorted
    last axis (``m`` valid entries; the low index clipped to ``upper``),
    interpolated in float32 as the JAX package does."""
    lo = int(min(max(np.floor(pos), 0), max(upper, 0)))
    frac = float(np.float32(pos - lo))
    a, b = xs[..., lo], xs[..., min(lo + 1, m - 1)]
    return a + frac * (b - a)


def _rank32(q, m):
    """The rank q * (m - 1) in float32, as the JAX package computes it for
    a count known only at run time (the final block)."""
    return np.float32(q) * (np.float32(m) - np.float32(1.0))


def _quantile_accumulators_many(quantiles, block_size, cvar=()):
    """(qsum_full, qsum_partial): per-block quantile and CVaR numerators of
    M nodes at once.

    The port of ``streaming._quantile_accumulators_many``.
    ``qsum_full(y)``, ``y`` an (M, block) tensor, is a full block's
    contribution to each node's count-weighted float64 vector of
    ``len(quantiles)`` quantiles then ``len(cvar)`` expected shortfalls,
    an (M, L) tensor; ``qsum_partial(y, cnt)`` that of a final block whose
    first ``cnt`` columns are valid.  A block that is a multiple of 2^17
    (and larger) is sorted as rows of 2^17, one ``torch.sort`` of M times
    block / 2^17 rows for every node and level, and the rows' order
    statistics are averaged; levels within 1/2^17 of 0 or 1 fall back to
    one sort of each node's block.  CVaR uses Rockafellar-Uryasev,
    ``ES_q = v + E[max(X - v, 0)] / (1 - q)``, on the same sorts.  Order
    statistics and interpolation are float32, as in the JAX package; sums
    are float64.
    """
    levels = tuple(quantiles) + tuple(cvar)
    nq = len(quantiles)
    rows_ok = (
        bool(levels)
        and block_size % _ROW == 0
        and block_size > _ROW
        and all(1.0 / _ROW <= q <= 1.0 - 1.0 / _ROW for q in levels)
    )
    f64 = torch.float64

    def empty(y):
        return torch.zeros((y.shape[0], 0), dtype=f64, device=y.device)

    def rows(y):
        # One sort of every node's rows of 2^17: (M, rows, 2^17).
        return torch.sort(y.reshape(-1, _ROW), dim=1).values.reshape(y.shape[0], -1, _ROW)

    def from_sorted(xs, m, upper, rank=lambda q, m: q * (m - 1)):
        # xs: (M, rows, m) sorted; each node's row estimates times m.
        out = []
        for i, q in enumerate(levels):
            v = _interp(xs, rank(q, m), m, upper)
            if i < nq:
                out.append(v.sum(dim=-1, dtype=f64) * m)
            else:
                tail = (xs - v[..., None]).clamp_min(0.0).sum(dim=-1, dtype=f64)
                es = v.double() + tail / float(np.float32(m * (1.0 - q)))
                out.append(es.sum(dim=-1) * m)
        return torch.stack(out, dim=-1)

    def qsum_full(y):
        if not levels:
            return empty(y)
        if rows_ok:
            return from_sorted(rows(y), _ROW, _ROW - 2)
        xs = torch.sort(y, dim=-1).values[:, None]
        return from_sorted(xs, block_size, block_size - 2)

    def qsum_partial(y, cnt):
        if not levels:
            return empty(y)
        if rows_ok and not cvar:
            # Full rows at the static positions; the boundary row of
            # ``rem`` valid entries at its own positions.
            n_full, rem = divmod(cnt, _ROW)
            out = torch.zeros((y.shape[0], nq), dtype=f64, device=y.device)
            if n_full:
                out = out + from_sorted(rows(y[:, : n_full * _ROW]), _ROW, _ROW - 2)
            if rem:
                row = torch.sort(y[:, n_full * _ROW : cnt], dim=-1).values
                out = out + torch.stack(
                    [
                        _interp(row, _rank32(q, rem), rem, _ROW - 2).double() * rem
                        for q in quantiles
                    ],
                    dim=-1,
                )
            return out
        # With CVaR levels, or blocks too small for rows: one sort of the
        # valid entries (the JAX package sorts the +inf-padded block).
        xs = torch.sort(y[:, :cnt], dim=-1).values[:, None]
        return from_sorted(xs, cnt, block_size - 2, _rank32)

    return qsum_full, qsum_partial


def _quantile_accumulators(quantiles, block_size, cvar=()):
    """(qsum_full, qsum_partial) of one node: ``_quantile_accumulators_many``
    on a (1, block) view.  ``qsum_full(x)`` is the float64 vector of
    ``len(quantiles)`` quantile then ``len(cvar)`` CVaR numerators of a
    full block, ``qsum_partial(x, cnt)`` that of a final block whose first
    ``cnt`` entries are valid."""
    full, partial = _quantile_accumulators_many(quantiles, block_size, cvar)
    return (lambda x: full(x[None])[0]), (lambda x, cnt: partial(x[None], cnt)[0])


def _histogram_accumulators(histogram):
    """``counts(x, mask=None)``: int64 ``(bins + 2,)`` counts of one block.

    ``histogram=(lo, hi, bins)``: ``bins`` equal half-open bins over
    ``[lo, hi)`` plus underflow and overflow, laid out as
    ``[underflow, bin_0 .. bin_{bins-1}, overflow]``; the bin index is
    ``clip(floor((x - lo) * bins / (hi - lo)), -1, bins) + 1`` in float32,
    as in the JAX package.  NaN and off-mask samples are counted nowhere;
    +/-inf count as underflow/overflow.  The indices are counted with
    ``torch.histc`` over the integer-valued bin numbers (exact: each
    index maps to its own bin, and float32 counts are exact up to 2^24
    per block, float64 beyond).
    """
    if histogram is None:
        return lambda x, mask=None: torch.zeros((0,), dtype=torch.int64, device=x.device)
    lo, hi, bins = histogram
    scale = bins / (hi - lo)

    def counts(x, mask=None):
        x = x.to(torch.float32)
        idx = torch.clamp(torch.floor((x - lo) * scale), -1.0, float(bins))
        drop = torch.isnan(x) if mask is None else torch.isnan(x) | ~mask
        idx = torch.where(drop, float(bins + 2), idx)  # outside histc's range
        if idx.numel() > 1 << 24:
            idx = idx.double()
        return torch.histc(idx, bins=bins + 2, min=-1.0, max=float(bins + 1)).to(torch.int64)

    return counts


def _histogram_accumulators_many(histogram):
    """``counts(y, mask=None)``: int64 ``(M, bins + 2)`` counts of the M
    rows of ``y`` (``_histogram_accumulators`` per node; ``mask`` is the
    block's shared condition)."""
    counts = _histogram_accumulators(histogram)
    return lambda y, mask=None: torch.stack([counts(row, mask) for row in y])


# ---------------------------------------------------------------------
# The block program
# ---------------------------------------------------------------------

_UNION_SINK_CACHE = {}


def _union_sink(sink, extras):
    """Cached NoOp rooting ``sink`` and out-of-graph extras in one plan."""
    from probabilit_tpu_torch.models import graph as _graph

    key = (sink._id, tuple(node._id for node in extras), _graph.Node._mutation_epoch)
    node = _UNION_SINK_CACHE.get(key)
    if node is None:
        if len(_UNION_SINK_CACHE) > 64:
            _UNION_SINK_CACHE.pop(next(iter(_UNION_SINK_CACHE)))
        node = _graph.NoOp(sink, *extras)
        _UNION_SINK_CACHE[key] = node
    return node


def _resolve_executor(plan, keep, executor, correlator):
    """"cuda" or None for ``executor`` in ("auto", "cuda", None)."""
    from probabilit_tpu_torch.engine import cuda_exec

    if executor == "pallas":
        raise ValueError(
            "executor='pallas' is the JAX package's TPU megakernel; the "
            "port's counterpart is executor='cuda'."
        )
    if executor not in ("auto", "cuda", None):
        raise ValueError(f"Unknown executor {executor!r}; use 'auto', 'cuda' or None.")
    if executor is None:
        return None
    resolved = _compile.resolve_correlator(correlator)
    ic_cls = _compile.CORRELATOR_MAP["imanconover"]
    exact_ic = resolved is ic_cls or type(resolved) is ic_cls
    if plan.corr_matrix is not None and not exact_ic:
        if executor == "cuda":
            raise ValueError("executor='cuda' supports correlator='imanconover' only.")
        return None
    graph_ok = cuda_exec.supports(plan, keep)
    if executor == "cuda":
        if not graph_ok:
            raise ValueError("Graph not eligible for executor='cuda'.")
        issue = cuda_exec.environment_issue()
        if issue is not None:
            raise ValueError(issue)
        return "cuda"
    if not graph_ok or config.device().type != "cuda" or _mesh.current_mesh() is not None:
        return None
    issue = cuda_exec.environment_issue()
    if issue is not None:
        raise RuntimeError(issue)
    return "cuda"


def _method_name(method, total_size):
    """The streamed method's name, after the JAX package's checks: an
    index-addressable method, within its index cap."""
    name = method.lower().strip()
    if name not in _STREAMED_METHODS:
        raise ValueError(
            "Streamed sampling requires an index-addressable method "
            f"('sobol', 'halton', 'lhs' or 'antithetic'), got {method!r}."
        )
    # Point indices are 32-bit (Halton's int32 digit loop: 2^31); past the
    # cap the stream would wrap and repeat points.
    cap = 2**31 if name == "halton" else 2**32
    if total_size is not None and total_size > cap:
        raise ValueError(
            f"Streamed {name} supports at most 2^{cap.bit_length() - 1} "
            f"points, got {total_size}. Use the PRNG stream (method=None) "
            "beyond that."
        )
    return name


def _block_program(
    sink, block_size, executor="auto", correlator="imanconover", extra=None, method=None,
    total_size=None,
):
    """(plan, run): ``run(b, seed) -> (sink block, extra block(s) or None)``.

    ``extra`` (a node, or a tuple of nodes) is sampled alongside the sink
    from the same draws; a node outside the sink's graph is rooted with
    it under a cached ``NoOp``.  Every block has ``block_size`` samples.
    With ``method=``, block b is rows ``[b*B, b*B + B)`` of the method's
    one sequence of ``total_size`` points under the seed.
    """
    from probabilit_tpu_torch.engine import cuda_exec

    if getattr(sink, "_vector_valued", False):
        raise ValueError(
            f"Cannot stream vector-valued node {sink!r}; stream scalar "
            "marginals or functionals of it instead."
        )
    out_sink = sink
    plan = _compile.get_plan(sink)
    single_extra = extra is not None and not isinstance(extra, (tuple, list))
    extras = () if extra is None else (extra,) if single_extra else tuple(extra)
    if extras and not all(any(node is req for node in plan.topo) for req in extras):
        sink = _union_sink(out_sink, extras)
        plan = _compile.get_plan(sink)
    keep = frozenset({out_sink._id} | {node._id for node in extras})

    def pair(outputs):
        x = outputs[out_sink._id]
        if extra is None:
            return x, None
        if single_extra:
            return x, outputs[extras[0]._id]
        return x, tuple(outputs[node._id] for node in extras)

    device = config.device()
    if method is not None:
        seeded = _compile.find_key_seeded(plan)
        if seeded is not None:
            raise ValueError(
                f"Streamed method={method!r} promises bitwise equality with a "
                f"single-shot run, but {seeded!r} is column-seeded: it draws "
                "from a generator keyed by its quantile column, whose per-block "
                "value differs from the single-shot column (and low-discrepancy "
                "or antithetic structure cannot reach keyed draws anyway). Use "
                "method=None for this graph."
            )
        if plan.corr_matrix is not None:
            raise ValueError(
                "Streamed QMC sampling requires a correlation-free graph; use "
                "method=None for streamed correlated sampling (per-block "
                "recolouring) or a single-shot sample()."
            )
        if executor == "cuda":
            raise ValueError(cuda_limits())
        if executor not in ("auto", None):
            _resolve_executor(plan, keep, executor, correlator)  # its own errors
        name = _method_name(method, total_size)
        body = _compile.build_body(plan, keep, correlator)
        # LHS stratifies over the whole run: block b draws its rows of the
        # total_size-point stratification.
        total = total_size if name == "lhs" else None

        def run(b, seed):
            q = _qmc.generate_sharded(
                name, seed, block_size, plan.d_total, config.float_dtype(),
                offset=b * block_size, total=total, device=device,
            )
            return pair(_compile.map_quantiles(plan, body, q))

        return plan, run

    if _resolve_executor(plan, keep, executor, correlator) == "cuda":
        order = cuda_exec.keep_order(plan, keep)
        tape = cuda_exec.lowered(plan, order, device)

        def run(b, seed):
            words = cuda_exec.seed_words(seed)
            start = b * block_size
            ab = None
            if plan.corr_matrix is not None:
                ab = cuda_exec.recolor_transform(
                    plan, words, block_size, device, start=start, solve=RECOLOR_SOLVE
                )
            out, _ = cuda_exec.run(tape, words, block_size, ab, start=start)
            return pair({nid: out[k] for k, nid in enumerate(order)})

        return plan, run

    generated = plan.corr_matrix is not None and _compile.recolor_eligible(
        plan, _compile.resolve_correlator(correlator)
    )
    body = _compile.build_body(plan, keep, correlator, generated=generated, drawn=True)

    def run(b, seed):
        q = _qmc.uniform(_derive_seed(seed, 0, b), block_size, plan.d, config.float_dtype(), device)
        return pair(_compile.map_quantiles(plan, body, q, drawn=True))

    return plan, run


# ---------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------


def sample_streaming(
    sink,
    size,
    block_size=16_777_216,
    random_state=None,
    executor="auto",
    method=None,
    correlator="imanconover",
):
    """Sample ``size`` draws of ``sink`` in device-sized blocks.

    Returns a host (numpy) array of length ``size``; device memory is
    bounded by one block.  Raises on non-finite samples, as ``sample``.
    ``method=`` streams one long QMC or antithetic sequence, equal to a
    single-shot ``sample(method=...)`` of the same size bit for bit.
    """
    size = int(size)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}.")
    plan, run = _block_program(
        sink, block_size, executor, correlator, method=method, total_size=size
    )
    seed = resolve_seed(random_state)
    out = None
    for b in range(-(-size // block_size)):
        lo = b * block_size
        hi = min(size, lo + block_size)
        block = run(b, seed)[0][: hi - lo].cpu().numpy()
        if out is None:
            out = np.empty((size,), dtype=block.dtype)
        out[lo:hi] = block
        if np.issubdtype(block.dtype, np.inexact) and not np.isfinite(block).all():
            raise ValueError(f"Sampling produced non-finite values (block {b}).")
    # Host finalizers (a string-valued DiscreteDistribution's values): the
    # same output as sample().
    finalize = plan.finalizers.get(sink._id)
    return out if finalize is None else finalize(out)


def estimate(
    sink,
    size,
    block_size=16_777_216,
    random_state=None,
    executor="auto",
    method=None,
    quantiles=None,
    cvar=None,
    histogram=None,
    replicates=None,
    correlator="imanconover",
    control=None,
    where=None,
    target_sem=None,
    target_rel_sem=None,
    max_size=None,
    moments=False,
    checkpoint=None,
    checkpoint_every=None,
):
    """Streaming Monte Carlo estimate of ``sink``: n, mean, var, std, sem,
    min, max, plus ``q<level>``, ``cvar<level>``, ``histogram``,
    ``skew``/``kurt`` (``moments=True``), the conditional statistics of
    ``where=node`` (``n`` accepted, ``n_total`` drawn, ``acceptance``),
    the control-variate estimate of ``control=(node, known_mean)``, and
    the between-replicate ``sem`` of ``replicates=R`` independent streams.

    The JAX package's ``estimate`` documents each option; the port keeps
    its conventions (quantiles by 2^17-sample row sorts with the endpoint
    fallback, upper-tail CVaR by Rockafellar-Uryasev, half-open histogram
    bins with under/overflow, scipy's biased skew and Fisher kurtosis,
    ``where=`` not with ``quantiles``/``cvar``/``control``).

    ``method="sobol"/"halton"/"lhs"/"antithetic"`` folds one long QMC or
    antithetic sequence instead of the PRNG stream.  Its iid ``sem`` is
    no valid QMC error bar: ``replicates=R`` re-randomises R streams and
    reports the between-replicate ``sem``, and a QMC ``target_sem`` needs
    it.

    ``target_sem`` / ``target_rel_sem`` run rounds, the first of ``size``
    draws, until the pooled ``sem`` (with ``replicates``, the
    between-replicate one) meets the target, ``max_size`` draws (default
    ``64 * size``) are spent or 64 rounds have run; the result adds
    ``rounds`` and ``converged``.  ``checkpoint=path`` saves the carries
    of segments of ``checkpoint_every`` draws (whole blocks; default 64
    blocks) as they complete and resumes from the file; the file is
    removed once the result is final.
    """
    with _profiling.span("probabilit.estimate"):
        size = int(size)
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}.")
        quantiles, cvar, histogram, control_node, control_mu = _check_options(
            quantiles, cvar, histogram, where, control
        )
        reps, targets = _check_run(
            size, random_state, method, replicates, target_sem, target_rel_sem, max_size,
            checkpoint, checkpoint_every,
        )
        seed = resolve_seed(random_state)
        opts = dict(
            quantiles=quantiles, cvar=cvar, histogram=histogram, moments=moments,
            correlator=correlator, control_node=control_node, where_node=where,
            method=method,
        )
        final = dict(
            quantiles=quantiles, control_mu=control_mu, where=where, cvar=cvar,
            histogram=histogram, moments=moments,
        )
        if targets is not None:
            if reps is not None:
                return _estimate_sequential_replicated(
                    sink, size, block_size, seed, executor, opts, final, *targets, reps
                )
            return _estimate_sequential(
                sink, size, block_size, seed, executor, opts, final, *targets
            )
        if checkpoint is not None:
            return _estimate_checkpointed(
                sink, size, block_size, seed, executor, opts, final, str(checkpoint),
                checkpoint_every,
            )
        if reps is None:
            carry = _estimate_carry(sink, size, block_size, seed, executor, **opts)
            return _finalize_estimate(carry, size, **final)
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps}) so every "
                "randomisation carries equal weight."
            )
        carries = [
            _estimate_carry(
                sink, size // reps, block_size, _derive_seed(seed, 1, r), executor, **opts
            )
            for r in range(reps)
        ]
        merged, rep_means = _merge_carries(carries, control_mu)
        stats = _finalize_estimate(merged, size, **final)
        rep = np.asarray(rep_means, np.float64)
        if rep.size < 2:
            raise ValueError(
                f"Only {rep.size} of {reps} replicates accepted any samples; the "
                "between-replicate sem needs >= 2. Loosen the where condition, "
                "raise size, or drop replicates=."
            )
        stats["sem"] = float(rep.std(ddof=1) / np.sqrt(rep.size))
        if control_mu is not None:
            stats["mean"] = float(rep.mean())
        stats["replicates"] = reps
        return stats


def _check_options(quantiles, cvar, histogram, where, control):
    """The JAX package's checks of ``estimate``'s and ``estimate_many``'s
    statistics: (quantiles, cvar, histogram, control node, control mean)."""
    from probabilit_tpu_torch.models.graph import Node

    quantiles = tuple(float(q) for q in quantiles) if quantiles else ()
    for q in quantiles:
        if not 0.0 < q < 1.0:
            raise ValueError(f"Quantile levels must be in (0, 1), got {q}.")
    cvar = tuple(float(q) for q in cvar) if cvar else ()
    for q in cvar:
        if not 0.0 < q < 1.0:
            raise ValueError(f"CVaR levels must be in (0, 1), got {q}.")
    if histogram is not None:
        histogram = _check_histogram(histogram)
    if where is not None:
        if not isinstance(where, Node):
            raise ValueError(f"where must be a graph node, got {where!r}.")
        if getattr(where, "_vector_valued", False):
            raise ValueError(
                f"where condition {where!r} is vector-valued; condition on a "
                "scalar functional of it instead."
            )
        if quantiles or cvar:
            raise ValueError(
                "where= does not compose with quantiles=/cvar= (the row-sort "
                "estimators assume unmasked blocks); estimate the conditional "
                "quantiles from sample_streaming output."
            )
        if control is not None:
            raise ValueError(
                "where= does not compose with control= (the control "
                "regression assumes unmasked blocks)."
            )
    control_node, control_mu = None, None
    if control is not None:
        try:
            control_node, control_mu = control
        except (TypeError, ValueError):
            raise ValueError(
                "control must be a (node, known_mean) pair, e.g. "
                "control=(cheap_part, analytic_mean)."
            ) from None
        if not isinstance(control_node, Node):
            raise ValueError(f"control[0] must be a graph node, got {control_node!r}.")
        control_mu = float(control_mu)
    return quantiles, cvar, histogram, control_node, control_mu


def _check_run(
    size, random_state, method, replicates, target_sem, target_rel_sem, max_size, checkpoint,
    checkpoint_every,
):
    """The checks of a run's shape, with the JAX package's messages and
    R3's refusal: (replicates or None, (target_sem, target_rel_sem,
    max_size) of a sequential run or None)."""
    sequential = target_sem is not None or target_rel_sem is not None
    if checkpoint is not None and (replicates is not None or sequential):
        raise ValueError(
            "checkpoint= composes with fixed-size single-stream runs "
            "only; checkpoint the fixed-size runs a replicated or "
            "sequential scheme decomposes into instead."
        )
    if checkpoint is None and checkpoint_every is not None:
        raise ValueError("checkpoint_every= needs checkpoint=path.")
    if checkpoint is not None and random_state is None:
        raise ValueError(
            "checkpoint= needs an explicit random_state: a run seeded from "
            "fresh entropy could never resume from its checkpoint."
        )
    if sequential and replicates is None:
        if (method or "").lower().strip() in ("sobol", "halton", "lhs"):
            raise ValueError(
                f"target_sem with method={method!r} needs replicates=R (e.g. "
                "replicates=8): the iid sem is not a valid QMC error bar; the "
                "between-replicate sem of R independently randomised streams "
                "is the valid stopping statistic."
            )
    reps = None
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream has no "
                "between-replicate variance to estimate sem from."
            )
    if not sequential:
        return reps, None
    for name, t in (("target_sem", target_sem), ("target_rel_sem", target_rel_sem)):
        if t is not None and not (float(t) > 0.0):
            raise ValueError(f"{name} must be > 0, got {t}.")
    max_size = 64 * size if max_size is None else int(max_size)
    if max_size < size:
        raise ValueError(f"max_size ({max_size}) must be >= the pilot size ({size}).")
    return reps, (
        None if target_sem is None else float(target_sem),
        None if target_rel_sem is None else float(target_rel_sem),
        max_size,
    )


def _check_histogram(histogram):
    try:
        h_lo, h_hi, h_bins = histogram
    except (TypeError, ValueError):
        raise ValueError(
            "histogram must be a (lo, hi, bins) triple, e.g. histogram=(-5.0, 5.0, 100)."
        ) from None
    h_lo, h_hi, h_bins = float(h_lo), float(h_hi), int(h_bins)
    if not (np.isfinite(h_lo) and np.isfinite(h_hi) and h_lo < h_hi):
        raise ValueError(f"histogram range must be finite with lo < hi, got ({h_lo}, {h_hi}).")
    if not 1 <= h_bins <= _HISTOGRAM_MAX_BINS:
        raise ValueError(f"histogram bins must be in [1, {_HISTOGRAM_MAX_BINS}], got {h_bins}.")
    return h_lo, h_hi, h_bins


# ---------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------


def _block_moments(x, y, cnt, where_mode, moments, covariance=False):
    """One block's (n, mean, M2, min, max, finite, (my, M2y, Cxy), M3, M4)
    over its first ``cnt`` samples, as float64 device tensors: scalars for
    one node's ``x``, (M,) vectors for the rows of an (M, block) ``x``
    (the count, control moments and finite flag stay scalars).  Under
    ``where=`` (``y`` the condition) off-condition samples are never
    inspected; otherwise ``y`` is the control (or None).  ``covariance``
    appends the rows' (M, M) central cross-product sums."""
    f64 = torch.float64
    xv = x[..., :cnt].to(f64)
    zero = torch.zeros((), dtype=f64, device=x.device)
    if where_mode:
        cond = y[:cnt] != 0
        n = cond.sum(dtype=f64)
        mean = torch.where(cond, xv, 0.0).sum(dim=-1) / n.clamp(min=1.0)
        d = torch.where(cond, xv - mean[..., None], 0.0)
        vmin = torch.where(cond, xv, torch.inf).amin(dim=-1)
        vmax = torch.where(cond, xv, -torch.inf).amax(dim=-1)
        finite = torch.where(cond, torch.isfinite(xv), True).all()
    else:
        n = torch.full((), float(cnt), dtype=f64, device=x.device)
        mean = xv.mean(dim=-1)
        d = xv - mean[..., None]
        vmin, vmax = xv.amin(dim=-1), xv.amax(dim=-1)
        finite = torch.isfinite(xv).all()
    d2 = d * d
    ctl = (zero, zero, zero)
    if y is not None and not where_mode:
        yv = y[:cnt].to(f64)
        my = yv.mean()
        dy = yv - my
        ctl = (my, (dy * dy).sum(), (d * dy).sum(dim=-1))
    m3, m4 = ((d2 * d).sum(dim=-1), (d2 * d2).sum(dim=-1)) if moments else (zero, zero)
    out = (n, mean, d2.sum(dim=-1), vmin, vmax, finite, ctl, m3, m4)
    return out + (d @ d.T,) if covariance else out


def _merge(carry, block, where_mode, moments):
    """Chan's pairwise merge of a block (or of a replicate's carry) into
    the carry (Pébay 2008 for M3 and M4), in float64 on device tensors
    (a node's scalars, or M nodes' vectors beside the shared count and
    control moments); reads the OLD m2/m3."""
    n_prev, mean, m2, vmin, vmax, finite, qsum, my, m2y, cxy, hsum, m3, m4 = carry
    bn, bm, bm2, bmin, bmax, bfinite, (bmy, bm2y, bcxy), bm3, bm4, bqsum, bhsum = block
    delta = bm - mean
    delta_y = bmy - my
    nn = n_prev + bn
    # Under where= a block (or the whole prefix) can accept nothing: every
    # numerator is 0 then, and a clamped denominator makes a no-op merge.
    nn_div = nn.clamp(min=1.0) if where_mode else nn
    w = n_prev * bn / nn_div
    if moments:
        m4 = m4 + bm4 + (
            delta**4 * w * (n_prev * n_prev - n_prev * bn + bn * bn) / nn_div**2
            + 6.0 * delta**2 * (n_prev * n_prev * bm2 + bn * bn * m2) / nn_div**2
            + 4.0 * delta * (n_prev * bm3 - bn * m3) / nn_div
        )
        m3 = m3 + bm3 + (
            delta**3 * w * (n_prev - bn) / nn_div
            + 3.0 * delta * (n_prev * bm2 - bn * m2) / nn_div
        )
    return (
        nn,
        mean + delta * bn / nn_div,
        m2 + bm2 + delta * delta * w,
        torch.minimum(vmin, bmin),
        torch.maximum(vmax, bmax),
        finite & bfinite,
        qsum + bqsum,
        my + delta_y * bn / nn_div,
        m2y + bm2y + delta_y * delta_y * w,
        cxy + bcxy + delta * delta_y * w,
        hsum + bhsum,
        m3,
        m4,
    )


def _merge_cov(csum, n_prev, mean, bn, bm, bcov, where_mode):
    """Chan's merge of the (M, M) co-moment sums: the outer product of
    the means' difference corrects them (reads the OLD mean)."""
    nn = n_prev + bn
    nn_div = nn.clamp(min=1.0) if where_mode else nn
    delta = bm - mean
    return csum + bcov + torch.outer(delta, delta) * (n_prev * bn / nn_div)


def _initial_carry(levels, hist_len, device, m=None):
    """The empty 13-field carry (see ``_estimate_carry``); with ``m``, the
    per-node fields are (m,) vectors (see ``_many_carry``)."""
    node = () if m is None else (m,)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float64, device=device)

    return (
        full((), 0.0), full(node, 0.0), full(node, 0.0), full(node, np.inf),
        full(node, -np.inf),
        torch.ones((), dtype=torch.bool, device=device),
        full((*node, levels), 0.0),
        full((), 0.0), full((), 0.0), full(node, 0.0),
        torch.zeros((*node, hist_len), dtype=torch.int64, device=device),
        full(node, 0.0), full(node, 0.0),
    )


def _estimate_carry(
    sink,
    size,
    block_size,
    seed,
    executor,
    quantiles=(),
    cvar=(),
    histogram=None,
    moments=False,
    correlator="imanconover",
    control_node=None,
    where_node=None,
    method=None,
    block_lo=0,
    n_blocks=None,
    last_count=None,
):
    """One stream's 13-field carry, as device tensors: (n, mean, M2, min,
    max, finite, qsum, my, M2y, Cxy, histogram counts, M3, M4).

    ``block_lo``/``n_blocks``/``last_count`` fold a window of the run's
    blocks (a checkpointed segment): blocks ``block_lo ..`` of the stream
    of ``size`` draws, the window's last holding ``last_count`` draws.  A
    block's index is absolute, so its draws are those of the
    uninterrupted run (``start = b * block_size`` on the kernels,
    ``_derive_seed(seed, 0, b)`` on the plain path, the method's points
    ``b * block_size ..`` under ``method=``; ``size`` stays the run's total,
    over which LHS stratifies).

    A block on a CUDA device is folded by the fold kernel
    (``cuda_exec.block_fold``) into the packed moment fields, one float64
    buffer for the whole window, returned as views of it; a block on the
    CPU by its plain twin, ``_block_moments`` and ``_merge``.  The quantile
    and histogram sums are added alike on both, where the run asks for
    them."""
    from probabilit_tpu_torch.engine import cuda_exec

    where_mode = where_node is not None
    aux = control_node if control_node is not None else where_node
    plan, run = _block_program(
        sink, block_size, executor, correlator, extra=aux, method=method, total_size=size
    )
    if plan.finalizers.get(sink._id) is not None:
        # A string-valued DiscreteDistribution samples indices on the
        # device; statistics of indices are not statistics of its values.
        raise ValueError(
            "estimate() requires a numeric sink; this node produces "
            "non-numeric values (e.g. a string-valued "
            "DiscreteDistribution). Use sample_streaming() instead."
        )
    qsum_full, qsum_partial = _quantile_accumulators(quantiles, block_size, cvar)
    hist = _histogram_accumulators(histogram)
    hist_len = 0 if histogram is None else histogram[2] + 2
    levels = len(quantiles) + len(cvar)
    carry = _initial_carry(levels, hist_len, config.device())
    qsum, hsum = carry[6], carry[10]
    # The moment fields: the plain carry's with empty quantile and
    # histogram fields, or on the card the fold kernel's packed buffer.
    moment_carry = _initial_carry(0, 0, config.device())
    packed = scratch = None
    if n_blocks is None:
        n_blocks = -(-size // block_size)
        last_count = size - (n_blocks - 1) * block_size
    for b in range(block_lo, block_lo + n_blocks):
        x, y = run(b, seed)
        with _profiling.span("probabilit.fold"):
            x = x.to(torch.float32)
            cnt = block_size if b < block_lo + n_blocks - 1 else last_count
            if x.device.type == "cuda":
                if packed is None:
                    packed = cuda_exec.pack_moments(moment_carry, x.device)
                    scratch = cuda_exec.fold_scratch(x.device)
                cuda_exec.block_fold(packed, x, y, cnt, where_mode, moments, scratch)
            else:
                stats = _block_moments(x, y, cnt, where_mode, moments)
                empty = (moment_carry[6], moment_carry[10])
                moment_carry = _merge(moment_carry, (*stats, *empty), where_mode, moments)
            if levels:
                qsum = qsum + (qsum_full(x) if cnt == block_size else qsum_partial(x, cnt))
            if histogram is not None:
                hsum = hsum + hist(x[:cnt], y[:cnt] != 0 if where_mode else None)
    if packed is not None:
        return cuda_exec.unpack_moments(packed, qsum, hsum)
    return (*moment_carry[:6], qsum, *moment_carry[7:10], hsum, *moment_carry[11:])


# The fields of a carry that hold one value per node: mean, M2, min, max,
# the quantile and CVaR sums, Cxy, the histogram counts, M3, M4.
_NODE_FIELDS = (1, 2, 3, 4, 6, 9, 10, 11, 12)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _merge_carries(carries, control_mu=None):
    """Chan-merge replicate carries on the host in float64; returns the
    pooled carry and the per-replicate (control-adjusted) means."""
    merged, rep_means = None, []
    for carry in carries:
        t, m, m2, lo, hi, f, q, my, m2y, cxy, h, m3, m4 = (
            torch.as_tensor(_host(v)) for v in carry
        )
        if merged is None:
            merged = _initial_carry(q.numel(), h.numel(), torch.device("cpu"))
        if float(t) <= 0.0:
            # A zero-accept replicate (where=) has no mean; it stays out
            # of the between-replicate sem, and its merge is a no-op.
            continue
        if control_mu is None:
            rep_means.append(float(m))
        else:
            adj, _, _, _ = _control_adjust(
                float(m), float(m2), float(my), float(m2y), float(cxy), control_mu
            )
            rep_means.append(adj)
        block = (t, m, m2, lo, hi, f, (my, m2y, cxy), m3, m4, q, h)
        merged = _merge(merged, block, where_mode=True, moments=True)
    return merged, rep_means


def _control_adjust(mx, m2x, my, m2y, cxy, mu):
    """(adjusted mean, variance-reduction factor 1-rho^2, beta, rho) of the
    regression control variate ``mean - beta * (my - mu)``,
    ``beta = Cov(x, y) / Var(y)``."""
    if m2y <= 0.0:
        return mx, 1.0, 0.0, 0.0
    beta = cxy / m2y
    rho2 = (cxy * cxy) / (m2x * m2y) if m2x > 0.0 else 0.0
    rho2 = min(rho2, 1.0)
    rho = (rho2**0.5) if cxy >= 0 else -(rho2**0.5)
    return mx - beta * (my - mu), 1.0 - rho2, beta, rho


def _finalize_estimate(
    carry, size, quantiles=(), control_mu=None, where=None, cvar=(), histogram=None,
    moments=False,
):
    """The statistics dict from a 13-field carry (device tensors or host
    values): ``_finalize_many`` of the carry lifted to one node's."""
    with _profiling.span("probabilit.wait"):
        fields = [_host(v) for v in carry]
    lifted = [np.asarray(v)[None] if i in _NODE_FIELDS else v for i, v in enumerate(fields)]
    return _finalize_many(
        [0], (*lifted, np.zeros((1, 1))), size, quantiles, cvar, histogram, control_mu, where,
        moments,
    )[0]


# ---------------------------------------------------------------------
# Sequential and checkpointed runs
# ---------------------------------------------------------------------


def _host_carry(carry):
    """A carry's fields as host (numpy) values."""
    return tuple(_host(v) for v in carry)


def _target(stats, target_sem, target_rel_sem):
    """The sem a sequential run must reach: the tighter of the targets."""
    tgt = np.inf
    if target_sem is not None:
        tgt = min(tgt, target_sem)
    if target_rel_sem is not None:
        tgt = min(tgt, target_rel_sem * abs(stats["mean"]))
    return tgt


def _next_round(drawn, sem, tgt, max_size):
    """Draws the next round needs (two-stage sizing): ``n * (sem/tgt)^2``
    inflated by 20% for the noise in sem, less what is drawn, growing at
    most 4x a round and within ``max_size``.  tgt == 0 (a relative target
    at mean 0) has no finite answer, so the run doubles to the cap."""
    if np.isfinite(sem) and sem > 0.0 and np.isfinite(tgt) and tgt > 0.0:
        need = drawn * (sem / tgt) ** 2 * 1.2 - drawn
    else:
        need = drawn
    return min(need, 3.0 * drawn, float(max_size - drawn))


def _round_chunk(chunk, budget, method=None):
    """One round's (per-replicate) draws: at least 1, at most ``budget``;
    an LHS chunk is rounded up to a power of two first, as in the JAX
    package (whose LHS program is compiled per stratification size), so
    both packages size the rounds alike."""
    chunk = max(int(chunk), 1)
    if method is not None and method.lower().strip() == "lhs":
        chunk = 1 << (chunk - 1).bit_length()
    return max(1, min(chunk, int(budget)))


def _estimate_sequential(
    sink, pilot, block_size, seed, executor, opts, final, target_sem, target_rel_sem, max_size
):
    """Sequential (precision-targeted) estimation: rounds of independent
    draws, round r from ``_derive_seed(seed, 2, r)``, Chan-merged on the
    host until the pooled ``sem`` meets the target (round sizes from
    ``_next_round``), ``max_size`` is drawn or ``_MAX_ROUNDS`` have run."""
    where = final["where"]
    carries, drawn, rounds, chunk = [], 0, 0, pilot
    while True:
        carry = _estimate_carry(
            sink, chunk, block_size, _derive_seed(seed, 2, rounds), executor, **opts
        )
        carries.append(_host_carry(carry))
        drawn += chunk
        rounds += 1
        merged, _ = _merge_carries(carries)
        if where is not None and float(merged[0]) <= 0.0:
            # A rare condition can leave the pilot empty: draw as much again
            # until a sample lands or the cap ends the run (the finalizer
            # raises the never-held error then).
            if drawn >= max_size:
                _finalize_estimate(merged, drawn, **final)
            chunk = min(drawn, max_size - drawn)
            continue
        stats = _finalize_estimate(merged, drawn, **final)
        sem, tgt = stats["sem"], _target(stats, target_sem, target_rel_sem)
        converged = bool(np.isfinite(sem) and sem <= tgt)
        if converged or drawn >= max_size or rounds >= _MAX_ROUNDS:
            stats["rounds"] = rounds
            stats["converged"] = converged
            return stats
        chunk = _round_chunk(_next_round(drawn, sem, tgt, max_size), max_size - drawn)


def _estimate_sequential_replicated(
    sink, pilot, block_size, seed, executor, opts, final, target_sem, target_rel_sem, max_size,
    reps,
):
    """Sequential stopping on the between-replicate sem: ``reps``
    independent streams grow round by round (replicate r's round k from
    ``_derive_seed(seed, 3, r, k)``); the stopping statistic is the
    standard error of the replicates' pooled (control-adjusted) means."""
    where, control_mu = final["where"], final["control_mu"]
    carries = [[] for _ in range(reps)]
    drawn, rounds = 0, 0
    method = opts["method"]
    chunk = _round_chunk(pilot // reps, max(1, max_size // reps), method)
    while True:
        for r in range(reps):
            carry = _estimate_carry(
                sink, chunk, block_size, _derive_seed(seed, 3, r, rounds), executor, **opts
            )
            carries[r].append(_host_carry(carry))
        drawn += chunk * reps
        rounds += 1
        pooled = [_merge_carries(rep)[0] for rep in carries]
        merged, rep_means = _merge_carries(pooled, control_mu)
        if where is not None and (float(merged[0]) <= 0.0 or len(rep_means) < 2):
            if drawn >= max_size:
                if float(merged[0]) <= 0.0:
                    _finalize_estimate(merged, drawn, **final)  # the never-held error
                raise ValueError(
                    f"Only {len(rep_means)} of {reps} replicates accepted any "
                    "samples within max_size; the between-replicate sem needs "
                    ">= 2. Loosen the where condition or raise max_size."
                )
            budget = max(1, (max_size - drawn) // reps)
            chunk = _round_chunk(min(drawn // reps, (max_size - drawn) // reps), budget, method)
            continue
        stats = _finalize_estimate(merged, drawn, **final)
        means = np.asarray(rep_means, np.float64)
        sem = float(means.std(ddof=1) / np.sqrt(means.size))
        stats["sem"] = sem
        if control_mu is not None:
            stats["mean"] = float(means.mean())
        tgt = _target(stats, target_sem, target_rel_sem)
        converged = bool(np.isfinite(sem) and sem <= tgt)
        if converged or drawn >= max_size or rounds >= _MAX_ROUNDS:
            stats["rounds"] = rounds
            stats["converged"] = converged
            stats["replicates"] = reps
            return stats
        need = _next_round(drawn, sem, tgt, max_size)
        chunk = _round_chunk(int(need) // reps, max(1, (max_size - drawn) // reps), method)


def _stream_fingerprint(sink, size, block_size, seg_blocks, seed, executor, opts):
    """Identity of a checkpointed run, stable across processes: the graph
    structure (``checkpoint.graph_fingerprint``), every size and option,
    the resolved correlator, the control and where graphs, the dtype and
    the 64-bit seed.  Resuming under any difference would splice the
    statistics of two runs."""
    control, where = opts["control_node"], opts["where_node"]
    parts = [
        _checkpoint.graph_fingerprint(sink),
        repr((
            int(size), int(block_size), int(seg_blocks), executor, opts["method"],
            tuple(opts["quantiles"]), tuple(opts["cvar"]), opts["histogram"],
            bool(opts["moments"]),
            _compile.correlator_token(_compile.resolve_correlator(opts["correlator"])),
            str(config.float_dtype()),
        )),
        "" if control is None else _checkpoint.graph_fingerprint(control),
        "" if where is None else "w" + _checkpoint.graph_fingerprint(where),
        f"{seed:x}",
    ]
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _save_stream_checkpoint(path, fingerprint, carries):
    """Persist the segments' host carries atomically (a temporary file,
    then a rename): float64 scalars, the finite flags, the quantile sums
    and the int64 histogram counts, as they are."""
    scalars = np.array([[c[i] for i in (0, 1, 2, 3, 4, 7, 8, 9, 11, 12)] for c in carries],
                       np.float64)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            fingerprint=np.asarray(fingerprint),
            scalars=scalars,
            finite=np.array([bool(c[5]) for c in carries]),
            qsum=np.stack([np.asarray(c[6], np.float64) for c in carries]),
            hsum=np.stack([np.asarray(c[10], np.int64) for c in carries]),
        )
    os.replace(tmp, path)


def _load_stream_checkpoint(path, fingerprint):
    """The saved segments' carries; refuses a file of another run."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "size, block/segment layout, method, features, or key "
                "differ); delete it to start fresh."
            )
        scalars, finite = data["scalars"], data["finite"]
        qsum, hsum = data["qsum"], data["hsum"]
    carries = []
    for i in range(scalars.shape[0]):
        t, m, m2, lo, hi, my, m2y, cxy, m3, m4 = scalars[i]
        carries.append((t, m, m2, lo, hi, bool(finite[i]), qsum[i], my, m2y, cxy, hsum[i], m3, m4))
    return carries


def _estimate_checkpointed(sink, size, block_size, seed, executor, opts, final, path, every):
    """Resumable streamed estimation: the run's blocks are cut into
    segments at fixed boundaries (``every`` draws, whole blocks), each
    segment folds as a window of the one stream (``_estimate_carry``'s
    ``block_lo``), and the segments' carries are saved after each one.  A
    rerun loads them and folds only the segments left; the final float64
    merge over the same carries makes the result bitwise that of the
    uninterrupted checkpointed run.  The file is removed only once the
    result is final, so a run that fails the finite check keeps it."""
    n_blocks = -(-size // block_size)
    last = size - (n_blocks - 1) * block_size
    seg_blocks = _SEGMENT_BLOCKS if every is None else max(1, int(every) // block_size)
    n_segs = -(-n_blocks // seg_blocks)
    fp = _stream_fingerprint(sink, size, block_size, seg_blocks, seed, executor, opts)
    carries = _load_stream_checkpoint(path, fp) if os.path.exists(path) else []
    for seg in range(len(carries), n_segs):
        lo = seg * seg_blocks
        nb = min(seg_blocks, n_blocks - lo)
        carry = _estimate_carry(
            sink, size, block_size, seed, executor, **opts, block_lo=lo, n_blocks=nb,
            last_count=last if lo + nb == n_blocks else block_size,
        )
        carries.append(_host_carry(carry))
        _save_stream_checkpoint(path, fp, carries)
    merged, _ = _merge_carries(carries)
    stats = _finalize_estimate(merged, size, **final)
    try:
        os.remove(path)
    except OSError:
        pass
    return stats


# ---------------------------------------------------------------------
# Joint estimates of several nodes
# ---------------------------------------------------------------------

_MANY_CACHE = {}
_MANY_BUILDS = 0  # block programs built by _many_program (the cache's tests read it)


def estimate_many(
    nodes,
    size,
    block_size=16_777_216,
    random_state=None,
    executor="auto",
    method=None,
    correlator="imanconover",
    quantiles=None,
    cvar=None,
    histogram=None,
    replicates=None,
    control=None,
    where=None,
    target_sem=None,
    target_rel_sem=None,
    max_size=None,
    moments=False,
    covariance=False,
    checkpoint=None,
    checkpoint_every=None,
):
    """One-pass streamed statistics of several nodes of one model.

    Returns ``{node: {n, mean, var, std, sem, min, max, ...}}`` where every
    node's statistics come from the same joint draws (a portfolio's desks
    and its total, all consistent with each other), which separate
    ``estimate`` calls cannot give: each sink gets its own column layout
    and so its own randomness.  The nodes are rooted under one cached
    ``NoOp``; each block is folded into (M,)-vector float64 carries on the
    device, so one pass serves every node.  The kernels refuse a ``NoOp``
    sink, as the TPU kernel does, so the blocks run on the plain executor
    (``executor="cuda"`` raises).

    Every option of ``estimate`` composes, per node, from the one joint
    stream and under the same rules: ``quantiles=`` and ``cvar=`` (one
    batched row sort a block for every node and level), ``histogram=``
    (one exact histogram a node), ``where=node`` (a shared condition),
    ``control=(node, known_mean)`` (one control, a ``control_beta`` and
    ``control_rho`` per node), ``replicates=R`` (each node's ``sem`` from
    the spread of R randomised streams), ``method=``, ``moments=True``
    (``skew``/``kurt``), ``target_sem``/``target_rel_sem`` (rounds until
    every node meets the target; the worst node sizes the next round) and
    ``checkpoint=``/``checkpoint_every=`` (the node list, in order, is part
    of the run's identity; an explicit ``random_state`` is required).
    ``covariance=True`` adds each node's row of the joint M x M ``cov``
    and ``corr`` in ``nodes`` order (``np.stack([out[n]["corr"] for n in
    nodes])`` rebuilds the matrix).
    """
    from probabilit_tpu_torch.models.graph import Node

    nodes = list(nodes)
    if not nodes:
        raise ValueError("estimate_many needs at least one node.")
    seen = set()
    for node in nodes:
        if not isinstance(node, Node):
            raise ValueError(f"estimate_many takes graph nodes, got {node!r}.")
        if getattr(node, "_vector_valued", False):
            raise ValueError(
                f"Cannot estimate vector-valued node {node!r}; request scalar "
                "marginals or functionals of it instead."
            )
        if node._id in seen:
            raise ValueError(f"{node!r} appears twice.")
        seen.add(node._id)
    size = int(size)
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}.")
    quantiles, cvar, histogram, control_node, control_mu = _check_options(
        quantiles, cvar, histogram, where, control
    )
    reps, targets = _check_run(
        size, random_state, method, replicates, target_sem, target_rel_sem, max_size, checkpoint,
        checkpoint_every,
    )
    seed = resolve_seed(random_state)
    opts = dict(
        method=method, quantiles=quantiles, cvar=cvar, histogram=histogram,
        correlator=correlator, control_node=control_node, where_node=where,
        moments=bool(moments), covariance=bool(covariance),
    )
    final = dict(
        quantiles=quantiles, cvar=cvar, histogram=histogram, control_mu=control_mu,
        where=where, moments=bool(moments), covariance=bool(covariance),
    )
    if targets is not None:
        if reps is not None:
            return _estimate_sequential_many_replicated(
                nodes, size, block_size, seed, executor, opts, final, *targets, reps
            )
        return _estimate_sequential_many(
            nodes, size, block_size, seed, executor, opts, final, *targets
        )
    if reps is not None:
        if size % reps:
            raise ValueError(
                f"size ({size}) must be divisible by replicates ({reps}) so every "
                "randomisation carries equal weight."
            )
        carries = [
            _host_carry(_many_carry(
                nodes, size // reps, block_size, _derive_seed(seed, 1, r), executor, **opts
            ))
            for r in range(reps)
        ]
        merged, rep_means = _merge_many_carries(carries, control_mu)
        out = _finalize_many(nodes, merged, size, **final)
        if len(rep_means) < 2:
            raise ValueError(
                f"Only {len(rep_means)} of {reps} replicates accepted any samples; "
                "the between-replicate sem needs >= 2. Loosen the where "
                "condition, raise size, or drop replicates=."
            )
        _replicate_sems(out, nodes, rep_means, control_mu)
        for node in nodes:
            out[node]["replicates"] = reps
        return out
    if checkpoint is not None:
        return _estimate_many_checkpointed(
            nodes, size, block_size, seed, executor, opts, final, str(checkpoint),
            checkpoint_every,
        )
    carry = _many_carry(nodes, size, block_size, seed, executor, **opts)
    return _finalize_many(nodes, carry, size, **final)


def _many_program(
    nodes, block_size, executor, method, lhs_total, quantiles, cvar, histogram, correlator,
    control_node, where_node, moments, covariance,
):
    """``fold(seed, block_lo, n_blocks, last_count) -> carry``: the block
    program of ``nodes`` (with the control or condition) under one
    ``NoOp``, its accumulators and the fold, cached per node list, graph
    epoch, block size and option (a later ``correlate()`` moves the epoch,
    so it never meets a stale program)."""
    global _MANY_BUILDS
    from probabilit_tpu_torch.models import graph as _graph

    key = (
        tuple(node._id for node in nodes), _graph.Node._mutation_epoch, block_size, executor,
        method, quantiles, cvar, histogram, lhs_total,
        _compile.correlator_token(_compile.resolve_correlator(correlator)),
        None if control_node is None else control_node._id,
        None if where_node is None else ("where", where_node._id),
        str(config.float_dtype()), str(config.device()), moments, covariance,
        _compile._active_mesh_key(),
    )
    fold = _MANY_CACHE.get(key)
    if fold is not None:
        return fold
    m = len(nodes)
    aux_node = control_node if control_node is not None else where_node
    where_mode = where_node is not None
    extras = tuple(nodes) + (() if aux_node is None else (aux_node,))
    plan, run = _block_program(
        _graph.NoOp(*extras), block_size, executor, correlator, extra=extras, method=method,
        total_size=lhs_total,
    )
    for node in nodes:
        if plan.finalizers.get(node._id) is not None:
            raise ValueError(
                f"{node!r} produces non-numeric values (host finalizer); "
                "estimate_many needs numeric nodes. Use sample_streaming()."
            )
    qsum_full, qsum_partial = _quantile_accumulators_many(quantiles, block_size, cvar)
    hist = _histogram_accumulators_many(histogram)
    hist_len = 0 if histogram is None else histogram[2] + 2
    levels = len(quantiles) + len(cvar)

    def fold(seed, block_lo, n_blocks, last_count):
        device = config.device()
        carry = (
            *_initial_carry(levels, hist_len, device, m=m),
            torch.zeros((m, m), dtype=torch.float64, device=device),
        )
        for b in range(block_lo, block_lo + n_blocks):
            _, ys = run(b, seed)
            y = torch.stack([v.to(torch.float32) for v in ys[:m]])
            aux = ys[m] if aux_node is not None else None
            cnt = block_size if b < block_lo + n_blocks - 1 else last_count
            stats = _block_moments(y, aux, cnt, where_mode, moments, covariance)
            qsum = qsum_full(y) if cnt == block_size else qsum_partial(y, cnt)
            counts = hist(y[:, :cnt], aux[:cnt] != 0 if where_mode else None)
            csum = carry[13]
            if covariance:
                csum = _merge_cov(csum, carry[0], carry[1], stats[0], stats[1], stats[9],
                                  where_mode)
            merged = _merge(carry[:13], (*stats[:9], qsum, counts), where_mode, moments)
            carry = (*merged, csum)
        return carry

    _MANY_BUILDS += 1
    if len(_MANY_CACHE) > 32:
        _MANY_CACHE.pop(next(iter(_MANY_CACHE)))
    _MANY_CACHE[key] = fold
    return fold


def _many_carry(
    nodes,
    size,
    block_size,
    seed,
    executor,
    method=None,
    quantiles=(),
    cvar=(),
    histogram=None,
    correlator="imanconover",
    control_node=None,
    where_node=None,
    moments=False,
    covariance=False,
    block_lo=0,
    n_blocks=None,
    last_count=None,
):
    """One stream's 14-field carry of M nodes, as device tensors: the
    13 fields of ``_estimate_carry`` with (M,) vectors for the mean, M2,
    min, max, Cxy, M3 and M4, an (M, L) quantile and CVaR sum and (M,
    bins + 2) int64 histogram counts (the count, control moments and
    finite flag are shared), then the (M, M) co-moment sums.

    ``block_lo``/``n_blocks``/``last_count`` fold a window of the run's
    blocks, as in ``_estimate_carry`` (a checkpointed segment)."""
    if method is not None:
        _method_name(method, size)  # the index cap, for every size
    lhs_total = size if method is not None and method.lower().strip() == "lhs" else None
    fold = _many_program(
        nodes, block_size, executor, method, lhs_total, quantiles, cvar, histogram, correlator,
        control_node, where_node, moments, covariance,
    )
    if n_blocks is None:
        n_blocks = -(-size // block_size)
        last_count = size - (n_blocks - 1) * block_size
    return fold(seed, block_lo, n_blocks, last_count)


def _merge_many_carries(carries, control_mu=None):
    """Chan-merge M-node carries on the host in float64; returns the
    pooled carry and the per-carry (M,) mean vectors (control-adjusted
    under ``control``, so a between-replicate sem prices the adjusted
    estimator of each node)."""
    merged, rep_means = None, []
    for carry in carries:
        fields = tuple(torch.as_tensor(_host(v)) for v in carry)
        t, m, m2, lo, hi, f, q, my, m2y, cxy, h, m3, m4, c = fields
        if merged is None:
            cpu = torch.device("cpu")
            merged = (*_initial_carry(q.shape[-1], h.shape[-1], cpu, m=m.numel()),
                      torch.zeros_like(c, dtype=torch.float64))
        if float(t) <= 0.0:
            # A zero-accept replicate (where=) has no means; it stays out
            # of the between-replicate sem, and its merge is a no-op.
            continue
        if control_mu is None:
            rep_means.append(m.numpy().copy())
        else:
            rep_means.append(np.array([
                _control_adjust(float(m[i]), float(m2[i]), float(my), float(m2y),
                                float(cxy[i]), control_mu)[0]
                for i in range(m.numel())
            ]))
        csum = _merge_cov(merged[13], merged[0], merged[1], t, m, c, where_mode=True)
        block = (t, m, m2, lo, hi, f, (my, m2y, cxy), m3, m4, q, h)
        merged = (*_merge(merged[:13], block, where_mode=True, moments=True), csum)
    return merged, rep_means


def _replicate_sems(out, nodes, rep_means, control_mu):
    """Each node's between-replicate sem (and, under a control, the mean
    of its adjusted replicate means) from the (R, M) replicate means;
    returns the sems."""
    rep = np.stack(rep_means)
    sems = rep.std(axis=0, ddof=1) / np.sqrt(rep.shape[0])
    for i, node in enumerate(nodes):
        out[node]["sem"] = float(sems[i])
        if control_mu is not None:
            out[node]["mean"] = float(rep[:, i].mean())
    return sems


def _finalize_many(
    nodes, carry, size, quantiles=(), cvar=(), histogram=None, control_mu=None, where=None,
    moments=False, covariance=False,
):
    """``{node: statistics}`` from a 14-field M-node carry (device tensors
    or host values); the field at index 10 holds the (M, bins + 2)
    histogram counts."""
    (total_, mean_, m2_, vmin_, vmax_, finite_, qsum_, my_, m2y_, cxy_, hsum_, m3_, m4_,
     csum_) = (_host(v) for v in carry)
    if not bool(finite_):
        raise ValueError("Sampling produced non-finite values.")
    total = float(total_)
    if where is not None and total <= 0:
        raise ValueError(
            f"where= condition never held across {size} draws; no conditional "
            "statistics exist. Loosen the condition or raise size."
        )
    qsum = np.asarray(qsum_, np.float64)
    mean_, m2_, m3_, m4_, cxy_ = (np.asarray(v, np.float64) for v in (mean_, m2_, m3_, m4_, cxy_))
    if covariance:
        cov = np.asarray(csum_, np.float64) / total if total else None
        if cov is not None:
            sd = np.sqrt(np.maximum(np.diag(cov), 0.0))
            denom = np.outer(sd, sd)
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = np.where(denom > 0.0, cov / denom, np.nan)
            np.fill_diagonal(corr, 1.0)  # 1 by construction, up to rounding
    out = {}
    for i, node in enumerate(nodes):
        var = float(m2_[i]) / total if total else float("nan")
        stats = {
            "n": int(round(total)) if where is not None else size,
            "mean": float(mean_[i]),
            "var": var,
            "std": var**0.5,
            "sem": (var / total) ** 0.5 if total else float("nan"),
            "min": float(np.asarray(vmin_)[i]),
            "max": float(np.asarray(vmax_)[i]),
        }
        if moments:
            sd3 = var**1.5
            stats["skew"] = float(m3_[i]) / total / sd3 if total and sd3 else float("nan")
            stats["kurt"] = float(m4_[i]) / total / var**2 - 3.0 if total and var else float("nan")
        if covariance:
            stats["cov"] = cov[i].copy() if cov is not None else np.full(len(nodes), np.nan)
            stats["corr"] = corr[i].copy() if cov is not None else np.full(len(nodes), np.nan)
        if where is not None:
            stats["n_total"] = size
            stats["acceptance"] = total / size
        if control_mu is not None:
            adj, factor, beta, rho = _control_adjust(
                stats["mean"], float(m2_[i]), float(my_), float(m2y_), float(cxy_[i]), control_mu
            )
            stats["mean"] = adj
            stats["sem"] = stats["sem"] * factor**0.5
            stats["control_beta"] = beta
            stats["control_rho"] = rho
            stats["control_mean"] = float(my_)
        for j, level in enumerate(quantiles):
            stats[f"q{level:g}"] = float(qsum[i, j] / total)
        for j, level in enumerate(cvar):
            stats[f"cvar{level:g}"] = float(qsum[i, len(quantiles) + j] / total)
        if histogram is not None:
            h_lo, h_hi, h_bins = histogram
            counts = np.asarray(hsum_, np.int64)[i]
            stats["histogram"] = {
                "edges": np.linspace(h_lo, h_hi, h_bins + 1),
                "counts": counts[1:-1],
                "underflow": int(counts[0]),
                "overflow": int(counts[-1]),
            }
        out[node] = stats
    return out


def _worst_ratio(out, nodes, sems, target_sem, target_rel_sem):
    """The binding node's sem / target: it decides both convergence and the
    next round's size (inf where a sem is not finite, or a relative target
    meets a zero mean)."""
    worst = 0.0
    for node, sem in zip(nodes, sems):
        tgt = _target(out[node], target_sem, target_rel_sem)
        if not np.isfinite(sem) or not tgt > 0.0:
            return np.inf
        worst = max(worst, sem / tgt)
    return worst


def _estimate_sequential_many(
    nodes, pilot, block_size, seed, executor, opts, final, target_sem, target_rel_sem, max_size
):
    """Sequential stopping for ``estimate_many``: rounds (round r from
    ``_derive_seed(seed, 2, r)``) until every node meets its target, the
    worst node sizing the next round (``_next_round``), ``max_size`` is
    drawn or ``_MAX_ROUNDS`` have run."""
    where = final["where"]
    carries, drawn, rounds, chunk = [], 0, 0, pilot
    while True:
        carry = _many_carry(
            nodes, chunk, block_size, _derive_seed(seed, 2, rounds), executor, **opts
        )
        carries.append(_host_carry(carry))
        drawn += chunk
        rounds += 1
        merged, _ = _merge_many_carries(carries)
        if where is not None and float(merged[0]) <= 0.0:
            if drawn >= max_size:
                _finalize_many(nodes, merged, drawn, **final)  # the never-held error
            chunk = min(drawn, max_size - drawn)
            continue
        out = _finalize_many(nodes, merged, drawn, **final)
        sems = [out[node]["sem"] for node in nodes]
        worst = _worst_ratio(out, nodes, sems, target_sem, target_rel_sem)
        converged = bool(np.isfinite(worst) and worst <= 1.0)
        if converged or drawn >= max_size or rounds >= _MAX_ROUNDS:
            for node in nodes:
                out[node]["rounds"] = rounds
                out[node]["converged"] = converged
            return out
        chunk = _round_chunk(
            _next_round(drawn, worst, 1.0, max_size), max_size - drawn, opts["method"]
        )


def _estimate_sequential_many_replicated(
    nodes, pilot, block_size, seed, executor, opts, final, target_sem, target_rel_sem, max_size,
    reps,
):
    """Replicated sequential stopping for ``estimate_many``: ``reps``
    streams grow round by round (replicate r's round k from
    ``_derive_seed(seed, 3, r, k)``); each node's stopping statistic is the
    between-replicate sem of its pooled replicate means, and the run goes
    on until every node meets its target."""
    where, control_mu, method = final["where"], final["control_mu"], opts["method"]
    carries = [[] for _ in range(reps)]
    drawn, rounds = 0, 0
    chunk = _round_chunk(pilot // reps, max(1, max_size // reps), method)
    while True:
        for r in range(reps):
            carry = _many_carry(
                nodes, chunk, block_size, _derive_seed(seed, 3, r, rounds), executor, **opts
            )
            carries[r].append(_host_carry(carry))
        drawn += chunk * reps
        rounds += 1
        pooled = [_merge_many_carries(rep)[0] for rep in carries]
        merged, rep_means = _merge_many_carries(pooled, control_mu)
        if where is not None and (float(merged[0]) <= 0.0 or len(rep_means) < 2):
            if drawn >= max_size:
                if float(merged[0]) <= 0.0:
                    _finalize_many(nodes, merged, drawn, **final)  # the never-held error
                raise ValueError(
                    f"Only {len(rep_means)} of {reps} replicates accepted any "
                    "samples within max_size; the between-replicate sem needs "
                    ">= 2. Loosen the where condition or raise max_size."
                )
            budget = max(1, (max_size - drawn) // reps)
            chunk = _round_chunk(min(drawn // reps, (max_size - drawn) // reps), budget, method)
            continue
        out = _finalize_many(nodes, merged, drawn, **final)
        sems = _replicate_sems(out, nodes, rep_means, control_mu)
        worst = _worst_ratio(out, nodes, sems, target_sem, target_rel_sem)
        converged = bool(np.isfinite(worst) and worst <= 1.0)
        if converged or drawn >= max_size or rounds >= _MAX_ROUNDS:
            for node in nodes:
                out[node]["rounds"] = rounds
                out[node]["converged"] = converged
                out[node]["replicates"] = reps
            return out
        need = _next_round(drawn, worst, 1.0, max_size)
        chunk = _round_chunk(int(need) // reps, max(1, (max_size - drawn) // reps), method)


def _save_many_checkpoint(path, fingerprint, carries):
    """Persist the segments' M-node host carries atomically (a temporary
    file, then a rename): float64 fields, the finite flags and the int64
    histogram counts, as they are."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            fingerprint=np.asarray(fingerprint),
            scalars=np.array([[c[0], c[7], c[8]] for c in carries], np.float64),  # t, my, m2y
            finite=np.array([bool(c[5]) for c in carries]),
            vecs=np.stack([  # (S, 7, M): mean, m2, min, max, cxy, m3, m4
                np.stack([np.asarray(c[i], np.float64) for i in (1, 2, 3, 4, 9, 11, 12)])
                for c in carries
            ]),
            qsum=np.stack([np.asarray(c[6], np.float64) for c in carries]),
            hsum=np.stack([np.asarray(c[10], np.int64) for c in carries]),
            csum=np.stack([np.asarray(c[13], np.float64) for c in carries]),
        )
    os.replace(tmp, path)


def _load_many_checkpoint(path, fingerprint):
    """The saved segments' M-node carries; refuses a file of another run."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "size, block/segment layout, method, features, or key "
                "differ); delete it to start fresh."
            )
        scalars, finite, vecs = data["scalars"], data["finite"], data["vecs"]
        qsum, hsum, csum = data["qsum"], data["hsum"], data["csum"]
    carries = []
    for i in range(scalars.shape[0]):
        t, my, m2y = scalars[i]
        m, m2, lo, hi, cxy, m3, m4 = vecs[i]
        carries.append(
            (t, m, m2, lo, hi, bool(finite[i]), qsum[i], my, m2y, cxy, hsum[i], m3, m4, csum[i])
        )
    return carries


def _estimate_many_checkpointed(
    nodes, size, block_size, seed, executor, opts, final, path, every
):
    """Resumable ``estimate_many``: the segments of ``_estimate_checkpointed``
    folded by ``_many_carry``.  The run's identity adds every node's graph,
    in order (resuming with the nodes reordered would splice statistics
    across nodes), and ``covariance``; the file goes only once the result
    is final."""
    n_blocks = -(-size // block_size)
    last = size - (n_blocks - 1) * block_size
    seg_blocks = _SEGMENT_BLOCKS if every is None else max(1, int(every) // block_size)
    n_segs = -(-n_blocks // seg_blocks)
    base = _stream_fingerprint(nodes[0], size, block_size, seg_blocks, seed, executor, opts)
    node_fps = "|".join(_checkpoint.graph_fingerprint(node) for node in nodes)
    fp = hashlib.sha256((base + node_fps + repr(opts["covariance"])).encode()).hexdigest()
    carries = _load_many_checkpoint(path, fp) if os.path.exists(path) else []
    for seg in range(len(carries), n_segs):
        lo = seg * seg_blocks
        nb = min(seg_blocks, n_blocks - lo)
        carry = _many_carry(
            nodes, size, block_size, seed, executor, **opts, block_lo=lo, n_blocks=nb,
            last_count=last if lo + nb == n_blocks else block_size,
        )
        carries.append(_host_carry(carry))
        _save_many_checkpoint(path, fp, carries)
    merged, _ = _merge_many_carries(carries)
    out = _finalize_many(nodes, merged, size, **final)
    try:
        os.remove(path)
    except OSError:
        pass
    return out
