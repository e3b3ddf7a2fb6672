"""Parameter sensitivities and Sobol' indices, through the plain executor.

Port of ``probabilit_tpu/engine/sensitivity.py``.  The JAX package swaps a
distribution's numeric parameters for traced scalars and differentiates
its traced sampling body with ``jax.value_and_grad``; here they are
swapped for 0-dim tensors that require grad, the plain executor
(``engine/compile.py::build_body``) evaluates the graph eagerly, and
``torch.autograd`` pulls the statistic back to them:

    d/dtheta  statistic(f(theta, U)),    U a fixed quantile matrix

(pathwise, or reparameterisation, derivatives; every draw is a common
random number).  Each entry point splits the draw from the
differentiated function: ``_build_grad_fn(...)(theta, quantiles)`` and
``_build_sobol_fn(...)(A, B)`` take explicit matrices, which is how the
tests hold the port to the JAX package on the same numbers.

No kernel lies on this path.  K1 (``engine/cuda_exec.py``) bakes the
parameters into its text as constants and K2 feeds it; neither has a
backward, so every gradient and Sobol' evaluation calls ``build_body``
itself, on ``config.device()``, and never ``estimate(executor="auto")``.

Streamed gradients (``block_size=``) run each block forward and backward
and free its graph, so device memory stays O(block).  Block b draws what
``estimate(executor=None)`` draws there (``_derive_seed(seed, 0, b)``, or
the method's points from ``b * block_size``), so the streamed value is
that estimate's mean.  The carries are float64 device tensors, merged on
the host in float64 across checkpointed segments.

Under a device mesh the quantiles are split by rows, each shard runs the
forward on its own rows, and the sink's rows are gathered on the first
device through a differentiable ``.to`` before the statistic
(``_sink_rows``), so autograd carries the gradient back through every
shard.

Where the port differs from the JAX package (ROADMAP C): ``checkpoint=``
needs an explicit ``random_state`` (R3: a run seeded from fresh entropy
could never resume), and the checkpoint file is removed only after a
finite result (R4: a failed run keeps its carries).  QMC on a correlated
graph is refused, as there (R5).
"""

from __future__ import annotations

import hashlib
import numbers
import os

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as _compile
from probabilit_tpu_torch.engine import streaming as _streaming
from probabilit_tpu_torch.engine.checkpoint import graph_fingerprint
from probabilit_tpu_torch.engine.sampler import resolve_seed
from probabilit_tpu_torch.ops import ppf as _ppf
from probabilit_tpu_torch.ops import qmc as _qmc

__all__ = [
    "sensitivity",
    "SensitivityResult",
    "sobol_indices",
    "SobolIndices",
]

_QMC_METHODS = ("sobol", "halton", "lhs", "antithetic")
_SEGMENT_BLOCKS = 64  # blocks a checkpointed segment holds by default


def _quantile(x, level):
    """``jnp.quantile(x, level)`` (linear interpolation) along the last axis,
    by one sort.

    ``torch.quantile`` refuses inputs past 2^24 elements; a sort and two
    gathers differentiate at any size, the gradient flowing through the
    sort's permutation.  The rank and weights are computed in ``x``'s
    float type, as jnp does; a NaN anywhere gives NaN, as there.  The
    rows of an ``(S, n)`` tensor (a batched sweep's scenarios) give ``(S,)``.
    """
    npt = np.float32 if x.dtype == torch.float32 else np.float64
    xs = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    pos = npt(level) * (npt(n) - npt(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = npt(1.0) - w_high
    low, high = int(min(max(low, 0), n - 1)), int(min(max(high, 0), n - 1))
    out = xs[..., low] * float(w_low) + xs[..., high] * float(w_high)
    return torch.where(torch.isnan(xs[..., -1]), xs[..., -1], out)  # sort puts NaN last


def _cvar(x, level):
    v = _quantile(x, level)
    tail = torch.maximum(x - v[..., None], torch.zeros_like(x))
    return v + torch.mean(tail, dim=-1) / (1.0 - level)


_STATISTICS = {
    "mean": torch.mean,
    "var": lambda x: torch.var(x, correction=1),
    "std": lambda x: torch.std(x, correction=1),
}


def _resolve_statistic(statistic):
    """-> (callable, hashable key); raises on unknown statistics.

    ``"q<level>"`` is the level quantile (its pathwise derivative flows
    through the sort permutation); ``"cvar<level>"`` the expected
    shortfall by Rockafellar-Uryasev, ``v + E[max(X - v, 0)] / (1 - q)``
    with ``v`` the level quantile, whose pathwise derivative is the
    Hong-Liu tail-conditional gradient (``torch.maximum`` splits a tie's
    gradient in half, as ``jnp.maximum`` does).  A callable receives the
    ``(size,)`` sample tensor and must return a scalar tensor that
    autograd can differentiate.
    """
    if isinstance(statistic, str):
        fn = _STATISTICS.get(statistic)
        if fn is not None:
            return fn, statistic
        for prefix, make in (("cvar", _cvar), ("q", _quantile)):
            if len(statistic) > len(prefix) and statistic.startswith(prefix):
                try:
                    level = float(statistic[len(prefix):])
                except ValueError:
                    break
                if 0.0 < level < 1.0:
                    return (lambda x, _level=level, _make=make: _make(x, _level)), statistic
                break
    elif callable(statistic):
        return statistic, id(statistic)
    raise ValueError(
        f"statistic must be one of {sorted(_STATISTICS)}, 'q<level>' "
        f"(e.g. 'q0.95'), 'cvar<level>' (e.g. 'cvar0.95'), or a callable; "
        f"got {statistic!r}."
    )


class SensitivityResult:
    """Statistic value + gradients, keyed by ``(node, parameter)``.

    ``gradients`` maps ``(node, name_or_position)`` to the float
    derivative of the statistic with respect to that parameter.  With
    ``replicates=R``, ``sems`` holds the between-replicate standard
    error of each gradient and ``value_sem`` that of the statistic;
    both are ``None`` otherwise.
    """

    def __init__(self, value, gradients, sems=None, value_sem=None):
        self.value = value
        self.gradients = gradients
        self.sems = sems
        self.value_sem = value_sem

    def __getitem__(self, key):
        return self.gradients[key]

    def __repr__(self):
        rows = ", ".join(
            f"d/d({node!r}, {slot!r})={g:.6g}" for (node, slot), g in self.gradients.items()
        )
        return f"SensitivityResult(value={self.value:.6g}, {rows})"


# ---------------------------------------------------------------------
# Parameter slots
# ---------------------------------------------------------------------


def _is_path_node(node):
    from probabilit_tpu_torch.models.processes import PathDistribution

    return isinstance(node, PathDistribution)


def _numeric_slots(node):
    """The numeric scalar parameter slots of a Distribution/path node."""
    if _is_path_node(node):
        # The family's differentiable attributes (jump rates and other
        # discrete drivers are left out there); joint multi-asset nodes
        # list indexed slots ("s0[0]", ...) over their parameter vectors.
        return list(node._param_slots)
    slots = [
        i for i, a in enumerate(node.args)
        if isinstance(a, numbers.Real) and not isinstance(a, bool)
    ]
    slots += [
        k for k, v in node.kwargs.items()
        if isinstance(v, numbers.Real) and not isinstance(v, bool)
    ]
    return slots


def _validate_family(node):
    from probabilit_tpu_torch.models.distributions import Distribution, _scipy_is_multivariate

    if _is_path_node(node):
        if not node._param_slots:
            raise ValueError(
                f"{type(node).__name__} declares no differentiable "
                "parameters (discrete-valued randomness has zero pathwise "
                "derivative a.e.)."
            )
        return
    if not isinstance(node, Distribution):
        raise TypeError(
            "sensitivity(wrt=...) targets parametric Distribution nodes "
            "or stochastic-process path nodes; "
            f"got {type(node).__name__}."
        )
    name = node.distr
    if _scipy_is_multivariate(name):
        raise ValueError(
            f'"{name}" is multivariate; parameter sensitivities are '
            "supported for univariate continuous families."
        )
    import scipy.stats as sps

    frozen = getattr(sps, name, None)
    if isinstance(frozen, sps.rv_discrete) or isinstance(
        getattr(frozen, "dist", None), sps.rv_discrete
    ):
        raise ValueError(
            f'"{name}" is discrete: its inverse CDF is a step function, so '
            "the pathwise derivative is zero almost everywhere and does not "
            "estimate the true parameter sensitivity (use a smoothed "
            "relaxation or score-function estimator instead)."
        )
    if _ppf.lookup(name) is None:
        raise ValueError(
            f'"{name}" samples through the host scipy fallback, which has '
            "no derivative; sensitivities need a native ppf kernel "
            "(ops/ppf.py)."
        )


# The shape parameters the JAX package cannot differentiate, by family:
# its inverse CDF reaches them through an incomplete-gamma Newton
# ``while_loop`` (no reverse mode) or through ``betainc``'s a and b (no
# gradient there).  The port refuses the same pairs before any draw rather
# than return a derivative of its own Newton tier or continued fraction.
_WHILE_LOOP = (
    "Reverse-mode differentiation does not work for the incomplete-gamma "
    "Newton inversion's while_loop"
)
_BETAINC = "Betainc gradient with respect to a and b not supported"
_NOT_DIFFERENTIABLE = {
    **{name: (_WHILE_LOOP, (shape,)) for name, shape in (
        ("gamma", "a"), ("erlang", "a"), ("chi2", "df"), ("chi", "df"),
        ("invgamma", "a"), ("nakagami", "nu"), ("dgamma", "a"), ("gengamma", "a"),
        ("gennorm", "beta"), ("halfgennorm", "beta"), ("loggamma", "c"),
        ("pearson3", "skew"), ("argus", "chi"),
    )},
    "beta": (_BETAINC, ("a", "b")),
    "betaprime": (_BETAINC, ("a", "b")),
    "t": (_BETAINC, ("df",)),
    "f": (_BETAINC, ("dfn", "dfd")),
    "rdist": (_BETAINC, ("c",)),
}


def _slot_name(node, slot):
    """The scipy parameter name of a Distribution's slot."""
    if isinstance(slot, str):
        return slot
    import scipy.stats as sps

    shapes = getattr(sps, node.distr).shapes
    names = ([s.strip() for s in shapes.split(",")] if shapes else []) + ["loc", "scale"]
    return names[slot] if slot < len(names) else str(slot)


def _refuse_untraceable(plan, pairs):
    """ValueError where a targeted parameter reaches an input the JAX
    package cannot differentiate: a refused shape slot of its own family,
    or such a slot of a downstream distribution whose parameter is a
    graph node that depends on a targeted one."""
    from probabilit_tpu_torch.models.distributions import Distribution
    from probabilit_tpu_torch.models.graph import Node

    def refuse(node, slot):
        reason = _NOT_DIFFERENTIABLE[node.distr][0]
        raise ValueError(
            f"{node!r}: the derivative with respect to {node.distr}'s "
            f"{_slot_name(node, slot)!r} is not available ({reason}); "
            "differentiate its loc and scale, or another parameter."
        )

    def refused(node, slot):
        entry = _NOT_DIFFERENTIABLE.get(getattr(node, "distr", None))
        return entry is not None and _slot_name(node, slot) in entry[1]

    for node, slot in pairs:
        if isinstance(node, Distribution) and refused(node, slot):
            refuse(node, slot)
    tainted = {node._id for node, _ in pairs}
    for node in plan.topo:
        if node._id in tainted:
            continue
        if isinstance(node, Distribution):
            params = list(enumerate(node.args)) + list(node.kwargs.items())
            for slot, value in params:
                if isinstance(value, Node) and value._id in tainted and refused(node, slot):
                    refuse(node, slot)
        if any(p._id in tainted for p in node.get_parents()):
            tainted.add(node._id)


def _normalize_wrt(plan, wrt):
    """-> list of (node, slot) pairs, validated against the plan."""
    from probabilit_tpu_torch.models.graph import Node

    if isinstance(wrt, Node):
        wrt = [wrt]
    if isinstance(wrt, dict):
        items = [(node, list(slots)) for node, slots in wrt.items()]
    else:
        items = [(node, None) for node in wrt]

    topo_ids = {n._id for n in plan.topo}
    pairs = []
    for node, slots in items:
        _validate_family(node)
        if node._id not in topo_ids:
            raise ValueError(f"{node!r} is not an ancestor of the sampled node.")
        available = _numeric_slots(node)
        if slots is None:
            slots = available
            if not slots:
                raise ValueError(
                    f"{node!r} has no numeric scalar parameters to "
                    "differentiate (Node-valued parameters are part of the "
                    "graph: target their own leaf distributions instead)."
                )
        for slot in slots:
            if slot not in available:
                raise ValueError(
                    f"{node!r} has no numeric scalar parameter {slot!r}; "
                    f"available: {available}."
                )
            pairs.append((node, slot))
    if not pairs:
        raise ValueError("wrt is empty.")
    return pairs


def _parse_slot(slot):
    """-> (attribute name, element index or None) of a path-node slot
    (``"s0[1]"`` is asset 1's spot of a joint multi-asset node)."""
    if isinstance(slot, str) and slot.endswith("]") and "[" in slot:
        name, idx = slot[:-1].split("[", 1)
        return name, int(idx)
    return slot, None


def _read_slot(node, slot):
    if _is_path_node(node):
        name, idx = _parse_slot(slot)
        attr = getattr(node, name)
        return attr if idx is None else attr[idx]
    if isinstance(slot, int):
        return node.args[slot]
    return node.kwargs[slot]


def _write_slot(node, slot, value):
    if _is_path_node(node):
        name, idx = _parse_slot(slot)
        if idx is None:
            setattr(node, name, value)
        else:
            # Out of place: a new vector with element idx replaced, never a
            # write into the node's numpy parameter.  Several indexed slots
            # of one attribute compose (each reads the previous vector).
            cur = torch.as_tensor(getattr(node, name), device=value.device)
            value = value.reshape(1).to(cur.dtype)
            setattr(node, name, torch.cat([cur[:idx], value, cur[idx + 1 :]]))
    elif isinstance(slot, int):
        args = list(node.args)
        args[slot] = value
        node.args = tuple(args)
    else:
        node.kwargs[slot] = value


def _save_slots(pairs):
    """The original objects to put back after a swap: a path node's whole
    attribute (once per attribute), so that an indexed slot's numpy vector
    comes back as the same object and ``.tobytes()`` signatures hold.  A
    joint node with a targeted indexed slot saves every attribute its
    slots index, which ``_swapped`` turns into tensors."""
    saved, seen = [], set()
    for node, slot in pairs:
        if _is_path_node(node):
            name, idx = _parse_slot(slot)
            names = [name] if idx is None else [_parse_slot(s)[0] for s in node._param_slots]
            for name in names:
                if (node._id, name) not in seen:
                    seen.add((node._id, name))
                    saved.append((node, name, True, getattr(node, name)))
        else:
            saved.append((node, slot, False, _read_slot(node, slot)))
    return saved


def _restore_slots(saved):
    for node, name_or_slot, is_attr, value in saved:
        if is_attr:
            setattr(node, name_or_slot, value)
        else:
            _write_slot(node, name_or_slot, value)


def _swapped(pairs, theta, fn):
    """``fn()`` with each targeted parameter replaced by its entry of the
    leaf ``theta``; the originals come back on every exit path."""
    saved = _save_slots(pairs)
    try:
        # A torch tensor and a numpy array do not mix in arithmetic, so a
        # joint node's indexed parameter vectors all become float64
        # tensors (their values exactly) before the targeted ones change.
        for node, name, is_attr, value in saved:
            if is_attr and isinstance(value, np.ndarray):
                vector = torch.as_tensor(value, dtype=torch.float64, device=theta.device)
                setattr(node, name, vector)
        for (node, slot), th in zip(pairs, theta.unbind()):
            _write_slot(node, slot, th)
        return fn()
    finally:
        _restore_slots(saved)


def _vjp(out, theta, cotangent=None, retain=False):
    """``d <out, cotangent> / d theta``; zeros where ``out`` does not depend
    on ``theta`` (``jax.grad``'s answer there)."""
    if not out.requires_grad:
        return torch.zeros_like(theta)
    (g,) = torch.autograd.grad(
        out, theta, grad_outputs=cotangent, retain_graph=retain, allow_unused=True
    )
    return torch.zeros_like(theta) if g is None else g


def _check_inexact(samples):
    if not samples.is_floating_point():
        raise ValueError(
            "The sampled node is integer-valued; its statistic has no "
            "parameter derivative."
        )


def _leaf(theta):
    return theta.detach().clone().requires_grad_(True)


# ---------------------------------------------------------------------
# sensitivity
# ---------------------------------------------------------------------


def sensitivity(
    sink,
    wrt,
    size=65536,
    random_state=None,
    statistic="mean",
    correlator="imanconover",
    method=None,
    block_size=None,
    replicates=None,
    checkpoint=None,
    checkpoint_every=None,
):
    """Pathwise derivative of ``statistic(sink samples)`` w.r.t. parameters.

    The JAX package's ``sensitivity`` documents each argument; the port
    keeps its contract, on ``config.device()`` through the plain executor:

    * ``wrt``: nodes (all numeric scalar parameters) or ``{node: [slots]}``;
      path nodes expose their family's differentiable attributes (GBM:
      ``s0``/``mu``/``sigma``, joint nodes indexed slots like ``"s0[1]"``).
    * ``statistic``: ``"mean"``, ``"var"``, ``"std"`` (``ddof=1``),
      ``"q<level>"``, ``"cvar<level>"`` or a callable of the sample tensor.
    * ``method=``: a QMC or antithetic matrix of ``plan.d_total`` columns
      (path nodes read their slabs); ``replicates=R`` re-randomises R
      streams (seeds ``_derive_seed(seed, 1, r)``) and reports ``sems``.
    * ``block_size=``: streamed gradients at any size, for ``"mean"``,
      ``"var"``, ``"std"`` (exact Chan folds of the block gradients) and
      ``"q<level>"``/``"cvar<level>"`` (two passes: the streamed quantile,
      then the Hong-Liu band or tail gradient mean); correlated graphs
      stream through the sort-free recolouring.
    * ``checkpoint=path`` (streamed ``"mean"``/``"var"``/``"std"``, with an
      explicit ``random_state``): segments of ``checkpoint_every`` draws
      (default 64 blocks) are saved as they complete, and a rerun resumes
      and finalizes bitwise as the uninterrupted checkpointed run; the
      file is removed once the result is finite.

    >>> import probabilit_tpu_torch as pt
    >>> x = pt.Distribution("norm", loc=2.0, scale=3.0)
    >>> res = pt.sensitivity(5 * x + 1, wrt=x, size=20000, random_state=0)
    >>> abs(res[(x, "loc")] - 5.0) < 1e-3   # doctest: +SKIP
    True
    """
    plan = _compile.get_plan(sink)
    pairs = _normalize_wrt(plan, wrt)
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The sampled node produces host-finalized (non-numeric) output; "
            "sensitivities need a numeric sink."
        )
    size = int(size)
    if size <= max(1, len(plan.corr_vars)):
        raise ValueError(f"size={size} is too small to estimate a statistic.")

    stat_fn, stat_key = _resolve_statistic(statistic)
    method_name = None if method is None else str(method).lower().strip()
    if method_name is not None:
        if method_name not in _QMC_METHODS:
            raise ValueError(f"method must be one of {_QMC_METHODS} or None, got {method!r}.")
        seeded = _compile.find_key_seeded(plan)
        if seeded is not None:
            raise ValueError(
                f"method={method!r} drives the run from an explicit "
                f"quantile matrix, but {seeded!r} draws from a "
                "column-seeded PRNG key; use method=None for this graph."
            )
        if plan.corr_matrix is not None:
            # R5, as in the JAX package.
            raise ValueError(
                "QMC sensitivities require a correlation-free graph "
                "(low-discrepancy structure does not survive correlation "
                "induction); use method=None."
            )
    if replicates is not None:
        reps = int(replicates)
        if reps < 2:
            raise ValueError(
                f"replicates must be >= 2 (got {reps}): a single stream "
                "has no between-replicate variance to estimate sems from."
            )
        if size % reps:
            raise ValueError(f"size ({size}) must be divisible by replicates ({reps}).")
        sub = size // reps
    else:
        reps, sub = None, size

    if checkpoint is not None:
        if block_size is None:
            raise ValueError(
                "checkpoint= applies to streamed gradients only; pass "
                "block_size= (a single-shot program has no mid-run state "
                "worth persisting)."
            )
        if reps is not None:
            raise ValueError(
                "checkpoint= composes with single-stream runs only; "
                "checkpoint the fixed-size runs a replicated scheme "
                "decomposes into instead."
            )
        if statistic not in ("mean", "var", "std"):
            raise ValueError(
                "checkpoint= supports statistic='mean'/'var'/'std' (the "
                "single-pass streamed folds); the two-pass VaR/CVaR "
                "scheme re-derives its pass-1 quantile from the whole "
                "stream and cannot resume from partial carries."
            )
        if random_state is None:
            # R3: the JAX package accepts this and can never resume.
            raise ValueError(
                "checkpoint= needs an explicit random_state: a run seeded from "
                "fresh entropy could never resume from its checkpoint."
            )
    elif checkpoint_every is not None:
        raise ValueError("checkpoint_every= needs checkpoint=path.")

    correlator_cls = _compile.resolve_correlator(correlator)
    _refuse_untraceable(plan, pairs)
    dtype, device = config.float_dtype(), config.device()
    theta0 = torch.tensor(
        [float(_read_slot(n, s)) for n, s in pairs], dtype=dtype, device=device
    )
    seed = resolve_seed(random_state)
    lhs_total = sub if method_name == "lhs" else None
    path = None

    if block_size is not None:
        block_size = int(block_size)
        tail_kind = tail_level = None
        if stat_key not in _STATISTICS and isinstance(stat_key, str):
            tail_kind = "cvar" if stat_key.startswith("cvar") else "q"
            tail_level = float(stat_key[len(tail_kind):])
        if stat_key not in _STATISTICS and tail_kind is None:
            raise ValueError(
                "block_size= (streamed gradients) supports statistic="
                "'mean'/'var'/'std' (exact blockwise Chan folds) and "
                "'q<level>'/'cvar<level>' (two-pass Hong-Liu tail "
                "streams); an arbitrary callable needs the full sample "
                "vector — drop block_size for it."
            )
        if plan.corr_matrix is not None and not _stream_corr_eligible(plan, correlator_cls):
            raise ValueError(
                "Streamed sensitivities on a correlated graph run through "
                "the generated sort-free recoloring, which needs a "
                "correlator with per-block score recoloring "
                "(ImanConover) over variables with "
                "monotone inverse CDFs; this graph/correlator pair is "
                "not eligible — drop block_size= to differentiate the "
                "single-shot correlated program."
            )
        n_blocks = -(-sub // block_size)
        last_count = sub - (n_blocks - 1) * block_size
        sampler = _make_block_sampler(
            plan, pairs, block_size, method_name, lhs_total, correlator_cls
        )

        if tail_kind is None:
            build = _build_stream_grad_fn if stat_key == "mean" else _build_stream_varstd_grad_fn
            grad_fn = build(sampler, block_size, len(pairs))
            if checkpoint is None:

                def run_one(s):
                    carry = _streaming._host_carry(grad_fn(theta0, s, 0, n_blocks, last_count))
                    return _finalize_stream_grad(stat_key, [carry])

            else:
                path = str(checkpoint)
                seg_blocks = (
                    _SEGMENT_BLOCKS
                    if checkpoint_every is None
                    else max(1, int(checkpoint_every) // block_size)
                )
                n_segs = -(-n_blocks // seg_blocks)
                n_scalars = 2 if stat_key == "mean" else 3

                def run_one(s):
                    fp = _grad_stream_fingerprint(
                        sink, pairs, theta0, sub, block_size, seg_blocks, s,
                        method_name, stat_key, correlator_cls,
                    )
                    carries = _load_grad_checkpoint(path, fp) if os.path.exists(path) else []
                    for k in range(len(carries), n_segs):
                        lo = k * seg_blocks
                        nb = min(seg_blocks, n_blocks - lo)
                        lc = last_count if lo + nb == n_blocks else block_size
                        carries.append(_streaming._host_carry(grad_fn(theta0, s, lo, nb, lc)))
                        _save_grad_checkpoint(path, fp, carries, n_scalars)
                    return _finalize_stream_grad(stat_key, carries)

        else:
            # Two passes.  Pass 1 is estimate()'s streamed quantile fold on
            # the same blocks; pass 2 streams the gradient mean over the
            # samples in a band around the level (VaR, Hong's conditional
            # band) or above it (CVaR, Hong-Liu).
            level = tail_level
            if tail_kind == "q":
                # Half-width 0.005 of probability, widened to ~1000 expected
                # samples at small sizes, never past halfway to a tail.
                half = min(level / 2.0, (1.0 - level) / 2.0)
                band = min(max(min(0.005, half), 500.0 / sub), half)
                q_levels, cvar_levels = (level - band, level, level + band), ()
            else:
                q_levels, cvar_levels = (level,), (level,)
            tail_fn = _build_stream_tail_grad_fn(sampler, block_size, len(pairs))

            def run_one(s):
                carry = _streaming._estimate_carry(
                    sink, sub, block_size, s, None, quantiles=q_levels, cvar=cvar_levels,
                    correlator=correlator_cls, method=method_name,
                )
                # For its checks (the finite flag); the levels are read by
                # position from the raw carry: their "q%g" keys collide for
                # a band narrower than 6 significant digits.
                _streaming._finalize_estimate(carry, sub, q_levels, cvar=cvar_levels)
                tails = _streaming._host(carry[6]).astype(np.float64) / float(carry[0])
                if tail_kind == "q":
                    v_lo, value, v_hi = (float(t) for t in tails[:3])
                else:
                    v_lo, v_hi, value = float(tails[0]), float("inf"), float(tails[1])
                cnt, gsum = tail_fn(theta0, s, n_blocks, last_count, v_lo, v_hi)
                cnt = float(cnt)
                if cnt <= 0.0:
                    raise ValueError(
                        f"No samples landed in the {stat_key} conditioning "
                        "band/tail; the level is too extreme for this size."
                    )
                return value, _streaming._host(gsum).astype(np.float64) / cnt

    else:
        drawn = method_name is None
        grad_fn = _build_grad_fn(plan, pairs, stat_fn, correlator_cls, drawn)
        width = plan.d if drawn else plan.d_total

        def run_one(s):
            q = _qmc.generate_sharded(
                method_name, s, sub, width, dtype, device=device, total=lhs_total
            )
            value, grad = grad_fn(theta0, q)
            return float(value), grad.detach().cpu().numpy().astype(np.float64)

    if reps is None:
        value, grads = run_one(seed)
        value = float(value)
        grads = np.asarray(grads, np.float64)
        sems = value_sem = None
    else:
        vs, gs = [], []
        for r in range(reps):
            v, g = run_one(_streaming._derive_seed(seed, 1, r))
            vs.append(float(v))
            gs.append(np.asarray(g, np.float64))
        vs, gs = np.asarray(vs), np.stack(gs)  # (R,), (R, P)
        value, grads = float(vs.mean()), gs.mean(axis=0)
        value_sem = float(vs.std(ddof=1) / np.sqrt(reps))
        gsem = gs.std(axis=0, ddof=1) / np.sqrt(reps)
        sems = {pair: float(s) for pair, s in zip(pairs, gsem)}
    if not np.all(np.isfinite(grads)) or not np.isfinite(value):
        raise FloatingPointError(
            "Non-finite sensitivity estimate (value "
            f"{value}, gradients {grads.tolist()}); the statistic or a ppf "
            "kernel is not differentiable at the current parameters."
        )
    if path is not None:
        # R4: only a finite result retires the carries.
        try:
            os.remove(path)
        except OSError:
            pass
    return SensitivityResult(
        value,
        {pair: float(g) for pair, g in zip(pairs, grads)},
        sems=sems,
        value_sem=value_sem,
    )


def _sink_rows(plan, body, pairs, theta, quantiles, drawn):
    """The sink's samples with ``pairs`` swapped for ``theta``'s entries.

    Under a device mesh each shard evaluates its own rows with its own
    copy of ``theta`` (``.to`` is differentiable, so autograd carries the
    gradient back to ``theta`` from every shard) and the rows are gathered
    on the first device before the statistic (``compile.map_quantiles``).
    """
    sink_id = plan.sink._id
    return _compile.map_quantiles(
        plan,
        lambda q: _swapped(pairs, theta.to(q.device), lambda: body(q)[sink_id]),
        quantiles,
        drawn,
    )


def _build_grad_fn(plan, pairs, stat_fn, correlator_cls, drawn):
    """``value_and_grad(theta, quantiles) -> (value, gradient)`` of the
    statistic over the plain executor's body.

    ``quantiles`` is the run's matrix: ``(n, plan.d)`` uniforms the engine
    drew (``drawn=True``, ``sample(method=None)``'s: declared correlations
    take the sort-free recolouring where ``recolor_eligible`` allows, and
    path nodes key their generators by their columns), or an explicit
    ``(n, plan.d_total)`` matrix (a ``method=``: the correlator's own
    transform, path nodes read their slabs).  ``theta`` holds the
    parameters in ``pairs``' order.
    """
    sink_id = plan.sink._id
    generated = (
        drawn and plan.corr_matrix is not None and _compile.recolor_eligible(plan, correlator_cls)
    )
    body = _compile.build_body(plan, {sink_id}, correlator_cls, generated=generated, drawn=drawn)

    def value_and_grad(theta, quantiles):
        theta = _leaf(theta)
        with torch.enable_grad():
            samples = _sink_rows(plan, body, pairs, theta, quantiles, drawn)
            _check_inexact(samples)
            value = stat_fn(samples)
            grad = _vjp(value, theta)
        return value.detach(), grad

    return value_and_grad


# ---------------------------------------------------------------------
# Streamed gradients
# ---------------------------------------------------------------------


def _stream_corr_eligible(plan, correlator_cls):
    """Can this correlated plan stream gradients?  Each block is recoloured
    with its own moments (streamed ``estimate()``'s sort-free branch), and
    the merge of the blocks' gradients is the exact gradient of that
    streamed estimator: ``compile.recolor_eligible``'s rule."""
    return _compile.recolor_eligible(plan, correlator_cls)


def _make_block_sampler(plan, pairs, block_size, method_name, lhs_total, correlator_cls):
    """``sample_block(theta, seed, b) -> (block_size,)`` float32 sink
    samples that carry ``theta``'s graph.

    Block b draws what ``estimate(executor=None)``'s block b draws: the
    uniforms of ``_derive_seed(seed, 0, b)`` (recoloured per block on a
    correlated graph), or rows ``b * block_size ..`` of the method's one
    sequence (LHS stratified over ``lhs_total``).
    """
    sink_id = plan.sink._id
    drawn = method_name is None
    generated = (
        drawn and plan.corr_matrix is not None and _stream_corr_eligible(plan, correlator_cls)
    )
    body = _compile.build_body(plan, {sink_id}, correlator_cls, generated=generated, drawn=drawn)
    dtype, device = config.float_dtype(), config.device()

    def sample_block(theta, seed, b):
        if drawn:
            q = _qmc.uniform(_streaming._derive_seed(seed, 0, b), block_size, plan.d, dtype, device)
        else:
            q = _qmc.generate_sharded(
                method_name, seed, block_size, plan.d_total, dtype,
                offset=b * block_size, total=lhs_total, device=device,
            )
        s = _sink_rows(plan, body, pairs, theta, q, drawn)
        _check_inexact(s)
        return s.to(torch.float32)

    return sample_block


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float64, device=config.device())


def _build_stream_grad_fn(sample_block, block_size, n_pairs):
    """``run(theta, seed, block_lo, n_blocks, last_count) -> (n, mean,
    mean_grad)``: the streamed mean and its gradient over a window of the
    run's blocks (absolute indices, so window carries merge to the
    uninterrupted run's).

    The gradient of a Chan-merged mean is the count-weighted mean of the
    block gradients: each block is one forward and one backward pass, its
    graph freed before the next.  The block mean and the merge are
    ``estimate()``'s, in float64.
    """

    def run(theta, seed, block_lo, n_blocks, last_count):
        theta = _leaf(theta)
        n, mv, mg = _zeros(), _zeros(), _zeros(n_pairs)
        for b in range(block_lo, block_lo + n_blocks):
            cnt = last_count if b == block_lo + n_blocks - 1 else block_size
            with torch.enable_grad():
                bv = sample_block(theta, seed, b)[:cnt].to(torch.float64).mean()
                bg = _vjp(bv, theta).to(torch.float64)
            bn = torch.full((), float(cnt), dtype=torch.float64, device=mv.device)
            nn = n + bn
            mv = mv + (bv.detach() - mv) * bn / nn
            mg = mg + (bg - mg) * bn / nn
            n = nn
        return n, mv, mg

    return run


def _build_stream_varstd_grad_fn(sample_block, block_size, n_pairs):
    """``run(...) -> (n, mean, M2, mean_g, C_xg)``: the streamed variance
    and its gradient over a window of blocks.

    With ``g_i = d x_i / d theta``,

        d Var / d theta = 2 * sum_i (x_i - xbar)(g_i - gbar) / (n - 1)

    is a cross co-moment of ``(x, g)``, Chan-merged like the control
    variate's.  Each block runs one forward pass and two pulls of its
    graph (cotangents ``1`` for ``sum g`` and ``x`` for ``sum x g``).
    ``std`` transforms at the end (``d std = d var / (2 std)``).
    """

    def run(theta, seed, block_lo, n_blocks, last_count):
        f64 = torch.float64
        theta = _leaf(theta)
        n, mean, m2 = _zeros(), _zeros(), _zeros()
        mg, cxg = _zeros(n_pairs), _zeros(n_pairs)
        for b in range(block_lo, block_lo + n_blocks):
            cnt = last_count if b == block_lo + n_blocks - 1 else block_size
            with torch.enable_grad():
                x = sample_block(theta, seed, b)[:cnt]
                gsum = _vjp(x, theta, torch.ones_like(x), retain=True).to(f64)
                xg = _vjp(x, theta, x.detach()).to(f64)
            xd = x.detach().to(f64)
            bn = torch.full((), float(cnt), dtype=f64, device=mean.device)
            bm = xd.mean()
            bm2 = ((xd - bm) ** 2).sum()
            bmg = gsum / bn
            bcxg = xg - bm * gsum  # sum (x - bm) g == sum (x - bm)(g - bmg)
            nn = n + bn
            delta, delta_g = bm - mean, bmg - mg
            w = n * bn / nn
            n, mean, m2, mg, cxg = (
                nn,
                mean + delta * bn / nn,
                m2 + bm2 + delta * delta * w,
                mg + delta_g * bn / nn,
                cxg + bcxg + delta * delta_g * w,
            )
        return n, mean, m2, mg, cxg

    return run


def _merge_grad_carries(stat_key, carries):
    """Host-side float64 Chan merge of streamed-gradient window carries:
    the device fold's update, so a resumed run finalizes from the same
    carry sequence as the uninterrupted one."""
    it = iter(carries)
    first = [np.asarray(v, np.float64) for v in next(it)]
    if stat_key == "mean":
        n, mv, mg = first
        for c in it:
            bn, bv, bg = (np.asarray(v, np.float64) for v in c)
            nn = n + bn
            mv = mv + (bv - mv) * bn / nn
            mg = mg + (bg - mg) * bn / nn
            n = nn
        return n, mv, mg
    total, mean, m2, mg, cxg = first
    for c in it:
        bn, bm, bm2, bmg, bcxg = (np.asarray(v, np.float64) for v in c)
        nn = total + bn
        d = bm - mean
        dg = bmg - mg
        w = total * bn / nn
        mean = mean + d * bn / nn
        m2 = m2 + bm2 + d * d * w
        mg = mg + dg * bn / nn
        cxg = cxg + bcxg + d * dg * w
        total = nn
    return total, mean, m2, mg, cxg


def _finalize_stream_grad(stat_key, carries):
    """``(value, (P,) float64 gradient)`` from raw window carries."""
    merged = _merge_grad_carries(stat_key, carries)
    if stat_key == "mean":
        _, mv, mg = merged
        return float(mv), np.asarray(mg, np.float64)
    n, _, m2, _, cxg = merged
    var = float(m2) / (float(n) - 1.0)
    dvar = 2.0 * np.asarray(cxg, np.float64) / (float(n) - 1.0)
    if stat_key == "std":
        sd = float(np.sqrt(var))
        return sd, dvar / (2.0 * sd)
    return var, dvar


def _grad_stream_fingerprint(
    sink, pairs, theta0, size, block_size, seg_blocks, seed, method_name, stat_key,
    correlator_cls,
):
    """Cross-process identity of a checkpointable streamed-gradient run:
    the graph, the targeted pairs (each node's own fingerprint and slot),
    the sizing, method, statistic, correlator and float type, the current
    parameter values (resuming after an edit would splice two models) and
    the seed."""
    parts = [
        graph_fingerprint(sink),
        repr([(graph_fingerprint(node), str(slot)) for node, slot in pairs]),
        repr((
            int(size), int(block_size), int(seg_blocks), method_name, stat_key,
            _compile.correlator_token(correlator_cls), str(config.float_dtype()),
        )),
        theta0.detach().cpu().to(torch.float64).numpy().tobytes().hex(),
        repr(int(seed)),
    ]
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _save_grad_checkpoint(path, fingerprint, carries, n_scalars):
    """Atomically persist the per-segment carry list (tmp + replace)."""
    sc = np.array([[float(c[i]) for i in range(n_scalars)] for c in carries], np.float64)
    vec = np.stack([
        np.stack([np.asarray(c[i], np.float64) for i in range(n_scalars, len(c))])
        for c in carries
    ])
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        np.savez(fh, fingerprint=np.asarray(fingerprint), scalars=sc, vecs=vec)
    os.replace(tmp, path)


def _load_grad_checkpoint(path, fingerprint):
    """-> the saved carry list; refuses a mismatched run."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["fingerprint"]) != fingerprint:
            raise ValueError(
                f"Checkpoint {path!r} belongs to a different run (graph, "
                "targeted parameters or their current values, sizing, "
                "method, statistic, or key differ); delete it to start "
                "fresh."
            )
        sc, vec = data["scalars"], data["vecs"]
    return [tuple(sc[i]) + tuple(vec[i]) for i in range(sc.shape[0])]


def _build_stream_tail_grad_fn(sample_block, block_size, n_pairs):
    """``run(theta, seed, n_blocks, last_count, v_lo, v_hi) -> (count,
    gradient sum)`` over the samples with ``v_lo <= x <= v_hi``: one pull
    of each block's graph with that indicator as the cotangent.  With
    ``(VaR, +inf)`` the ratio is the Hong-Liu tail-conditional gradient
    ``E[dX/dtheta | X >= VaR]`` (the CVaR derivative); a narrow band
    around the level gives ``E[dX/dtheta | X = VaR]`` (the VaR's)."""

    def run(theta, seed, n_blocks, last_count, v_lo, v_hi):
        theta = _leaf(theta)
        # The bounds compare in float32, as the samples.
        lo, hi = float(np.float32(v_lo)), float(np.float32(v_hi))
        count, gsum = _zeros(), _zeros(n_pairs)
        for b in range(n_blocks):
            cnt = last_count if b == n_blocks - 1 else block_size
            with torch.enable_grad():
                x = sample_block(theta, seed, b)[:cnt]
                band = ((x >= lo) & (x <= hi)).to(x.dtype)
                g = _vjp(x, theta, band)
            count = count + band.sum(dtype=torch.float64)
            gsum = gsum + g.to(torch.float64)
        return count, gsum

    return run


# =====================================================================
# Variance-based global sensitivity: Sobol' indices
# =====================================================================


class SobolIndices:
    """First-order and total Sobol' indices, keyed by variable node.

    ``first_order[node]`` is the fraction of the sink's variance explained
    by that variable alone; ``total_order[node]`` includes every
    interaction it takes part in; ``second_order[(a, b)]`` (and ``(b,
    a)``), with ``second_order=True``, the pure pairwise interaction.
    Estimates are Monte Carlo (may fall slightly outside [0, 1]).
    """

    def __init__(self, variables, first_order, total_order, mean, variance, size,
                 second_order=None):
        self.variables = list(variables)
        self.first_order = dict(zip(variables, first_order))
        self.total_order = dict(zip(variables, total_order))
        self.mean = mean
        self.variance = variance
        self.size = size
        self.second_order = second_order

    def __getitem__(self, node):
        return (self.first_order[node], self.total_order[node])

    def __repr__(self):
        rows = ", ".join(
            f"{node!r}: S={self.first_order[node]:.4f} ST={self.total_order[node]:.4f}"
            for node in self.variables
        )
        extra = ""
        if self.second_order:
            seen, parts = set(), []
            for (a, b), v in self.second_order.items():
                key = frozenset((id(a), id(b)))
                if key in seen:
                    continue
                seen.add(key)
                parts.append(f"S({a!r},{b!r})={v:.4f}")
            extra = ", " + ", ".join(parts)
        return f"SobolIndices(variance={self.variance:.6g}, {rows}{extra})"


def sobol_indices(sink, wrt=None, size=8192, random_state=None, method="sobol",
                  second_order=False):
    """Variance-based global sensitivity of ``sink`` to its variables.

    Pick-freeze (Saltelli) estimation on base matrices A and B: the sink
    is evaluated on A, on B, and on A with variable i's quantile columns
    taken from B, all ``(2 + k) * size`` rows in one call of the plain
    executor's body.  First-order indices use the Sobol'-Saltelli
    estimator ``S_i = mean(f(B) (f(AB_i) - f(A))) / Var``, totals Jansen's
    ``ST_i = mean((f(A) - f(AB_i))^2) / (2 Var)``; ``second_order=True``
    adds Saltelli-2002 closed pairs (``k(k-1)/2`` more matrices in the same
    batch) and reports ``S_ij = S_ij^closed - S_i - S_j``.

    ``wrt`` defaults to every initial sampling node; a path node swaps all
    its columns (its driver slab) together.  A and B are the two halves
    of one ``2 * d_total``-column matrix of ``method`` (``"sobol"``,
    ``"halton"``, ``"lhs"``, ``"antithetic"``, or None for iid uniforms).
    The sink must be numeric and the graph free of declared correlations.
    """
    from probabilit_tpu_torch.models.graph import Node

    plan = _compile.get_plan(sink)
    if plan.corr_matrix is not None:
        raise ValueError(
            "sobol_indices requires independent inputs, but the model "
            "declares correlations; variance attribution under dependence "
            "is not identifiable with pick-freeze estimators."
        )
    if plan.finalizers.get(sink._id) is not None:
        raise ValueError(
            "The sampled node produces host-finalized (non-numeric) "
            "output; Sobol' indices need a numeric sink."
        )
    if wrt is None:
        variables = list(plan.isns)
        if not variables:
            raise ValueError("The model has no sampling nodes.")
    else:
        variables = [wrt] if isinstance(wrt, Node) else list(wrt)
        if not variables:
            raise ValueError("wrt is empty.")
        seen = set()
        for v in variables:
            if v._id not in plan.col_of:
                raise ValueError(
                    f"{v!r} is not a distribution node of the sampled "
                    "graph; Sobol' indices attribute variance to sampling "
                    "nodes (transforms are deterministic given those)."
                )
            if v._id in seen:
                raise ValueError(f"{v!r} appears twice in wrt.")
            seen.add(v._id)
    cols = tuple(plan.columns_of(v) for v in variables)

    size = int(size)
    if size < 4:
        raise ValueError(f"size={size} is too small to estimate variances.")
    method_name = None if method is None else str(method).lower().strip()
    pair_positions = ()
    if second_order:
        k = len(cols)
        if k < 2:
            raise ValueError("second_order needs at least two variables to interact.")
        pair_positions = tuple((i, j) for i in range(k) for j in range(i + 1, k))

    d = plan.d_total
    AB = _qmc.generate(
        method_name, resolve_seed(random_state), size, 2 * d, config.float_dtype(),
        device=config.device(),
    )
    fn = _build_sobol_fn(plan, cols, pair_positions)
    mean, variance, first, total, closed = (
        np.asarray(v.detach().cpu().numpy(), np.float64) for v in fn(AB[:, :d], AB[:, d:])
    )
    if not np.isfinite(variance) or variance <= 0.0:
        raise FloatingPointError(
            f"Sink variance estimate is {variance}; Sobol' indices are "
            "undefined for a constant (or non-finite) quantity."
        )
    second = None
    if second_order:
        second = {}
        for (i, j), c in zip(pair_positions, closed):
            s_ij = float(c - first[i] - first[j])
            second[(variables[i], variables[j])] = s_ij
            second[(variables[j], variables[i])] = s_ij
    return SobolIndices(
        variables,
        [float(s) for s in first],
        [float(t) for t in total],
        float(mean),
        float(variance),
        size,
        second_order=second,
    )


def _build_sobol_fn(plan, col_sets, pair_positions=()):
    """``run(A, B) -> (mean, var, S, ST, closed_pairs)`` of the pick-freeze
    design on explicit ``(size, d_total)`` base matrices.

    ``col_sets[i]`` is variable i's full set of quantile columns
    (``Plan.columns_of``): its own column, and a path node's driver slab,
    which swap together; the matrices span ``d_total``, so path nodes
    evaluate in quantile mode.
    """
    sink_id = plan.sink._id
    body = _compile.build_body(plan, {sink_id})
    d = plan.d_total
    k = len(col_sets)
    sets = list(col_sets) + [tuple(col_sets[i]) + tuple(col_sets[j]) for i, j in pair_positions]
    hot_np = np.zeros((len(sets), 1, d), bool)
    for row, cs in enumerate(sets):
        hot_np[row, 0, list(cs)] = True

    def run(A, B):
        size = A.shape[0]
        hot = torch.from_numpy(hot_np).to(A.device)
        # Copy i of A takes its set's columns from B (copies k.. the closed
        # pairs'): one (2 + k + pairs) * size batch.
        stacked = torch.cat([A[None], B[None], torch.where(hot, B[None], A[None])])
        y = _compile.map_quantiles(plan, lambda q: body(q)[sink_id], stacked.reshape(-1, d))
        if not y.is_floating_point():
            y = y.to(config.float_dtype())
        y = y.reshape(2 + len(sets), size)
        fA, fB, fAB = y[0], y[1], y[2 : 2 + k]
        both = torch.cat([fA, fB])
        mean = torch.mean(both)
        variance = torch.var(both, correction=1)
        first = torch.mean(fB[None, :] * (fAB - fA[None, :]), dim=1) / variance
        total = 0.5 * torch.mean((fA[None, :] - fAB) ** 2, dim=1) / variance
        closed = torch.mean(fB[None, :] * (y[2 + k :] - fA[None, :]), dim=1) / variance
        return mean, variance, first, total, closed

    return run
