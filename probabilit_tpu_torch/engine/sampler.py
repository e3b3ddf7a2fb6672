"""Sampling orchestration: the public ``.sample()`` entry point.

Port of ``probabilit_tpu/engine/sampler.py:45-257``.  Two executors:

* ``executor=None``: the plain PyTorch executor on ``config.device()``.
  Uniforms come from a ``torch.Generator`` seeded by ``random_state`` (or,
  with ``method=``, from a QMC or antithetic sequence, ``ops/qmc.py``),
  and ``engine/compile.py::build_body`` evaluates the graph op by op;
  declared correlations take its sort-free recolouring branch on the
  generator's uniforms and the correlator's own transform on a method's.
* ``executor="cuda"``: the whole graph in one CUDA kernel generated for
  the graph's structure (``engine/cuda_exec.py``; the first call on a new
  structure builds it with nvcc), with Philox4x32-10 bits drawn inside it; a
  correlated graph first runs the correlation-statistics kernel over the
  same bits.  The counterpart of the JAX package's ``executor="pallas"``.

The two executors draw different random streams; each is deterministic
per seed.

Under a device mesh (``parallel/mesh.py``) the plain executor splits the
rows over the shards (``compile.map_quantiles``): a ``method=`` sequence
is generated shard by shard (``qmc.generate_sharded``), the generator's
uniforms of ``method=None`` are drawn on ``mesh.devices[0]`` and split,
and the samples come back as one tensor there.  ``executor="cuda"``
refuses a mesh, as the JAX package's ``executor="pallas"`` does.

With ``PROBABILIT_TPU_PROFILE=1`` either executor times its
build+compile, execute and host phases (``utils/profiling.PhaseTimer``,
each phase synchronised with the card) and prints them to stderr.  Under
a ``torch.profiler`` session a call records a ``probabilit.sample`` span,
and each of its waits for the device a ``probabilit.wait`` span
(``utils/profiling.span``).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as _compile
from probabilit_tpu_torch.ops import qmc as _qmc
from probabilit_tpu_torch.parallel import mesh as _mesh
from probabilit_tpu_torch.utils import profiling as _profiling

__all__ = ["sample", "sample_from_quantiles", "resolve_seed"]


def resolve_seed(random_state):
    """Map ``random_state`` (None, an int, or a numpy ``Generator`` or
    ``RandomState``) to an integer seed: None draws fresh entropy, a
    ``Generator`` or ``RandomState`` is advanced by one draw, as the JAX
    package's ``resolve_key`` advances it."""
    if random_state is None:
        return int(np.random.SeedSequence().entropy % (2**63))
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    if isinstance(random_state, np.random.Generator):
        return int(random_state.integers(2**63))
    if isinstance(random_state, np.random.RandomState):
        return int(random_state.randint(2**31))
    raise TypeError(f"Cannot interpret random_state: {random_state!r}")


def _phase(timer, name, device):
    """``timer``'s phase, or nothing when profiling is off."""
    return contextlib.nullcontext() if timer is None else timer.phase(name, device)


def _report(timer):
    if timer is not None:
        print(f"[probabilit-tpu profile] sample() phases:\n{timer.report()}", file=sys.stderr)


def _clear_samples(plan):
    for node in plan.topo:
        if hasattr(node, "samples_"):
            delattr(node, "samples_")


def sample(
    sink,
    size=None,
    random_state=None,
    method=None,
    correlator="imanconover",
    gc_strategy=None,
    executor=None,
):
    with _profiling.span("probabilit.sample"):
        size = 1 if size is None else int(size)
        plan = _compile.get_plan(sink)

        if executor == "pallas":
            raise ValueError(
                "executor='pallas' is the JAX package's TPU megakernel; the "
                "port's counterpart is executor='cuda'."
            )
        if executor == "cuda":
            return _sample_cuda(plan, size, random_state, method, correlator, gc_strategy)
        if executor is not None:
            raise ValueError(f"Unknown executor {executor!r}; use None or 'cuda'.")
        # method=None draws iid uniforms from a torch.Generator, one column a
        # node (a path node keys its own draws by its column), and declared
        # correlations take the sort-free recolouring; a QMC or antithetic
        # method gives an explicit quantile matrix of plan.d_total columns, a
        # path node's slab of drivers included, which the correlator
        # transforms (the JAX package's quantile path).
        drawn = method is None
        quantiles = _qmc.generate_sharded(
            method,
            resolve_seed(random_state),
            size,
            plan.d if drawn else plan.d_total,
            dtype=config.float_dtype(),
            device=config.device(),
        )
        generated = (
            drawn
            and plan.corr_matrix is not None
            and _compile.recolor_eligible(plan, _compile.resolve_correlator(correlator))
        )
        return _execute(plan, quantiles, correlator, gc_strategy, generated, drawn)


def cuda_limits():
    """What ``executor="cuda"`` needs, for its refusals."""
    from probabilit_tpu_torch.engine import cuda_exec

    return (
        "executor='cuda' requires method=None (the kernel draws its own "
        "Philox stream; QMC and antithetic quantiles run on executor=None), "
        "a narrow gc_strategy keep-list (<= 16 kept nodes; [] keeps just the "
        f"sink), at most {cuda_exec.MAX_CORR_K} correlated variables, and the "
        "nodes the kernel has (cuda_exec.supports): constants; the "
        "megakernel's families with numeric parameters (closed forms, and "
        "Newton families within their caps); CDF tables and numeric "
        "Discrete, Cumulative and linear Empirical tables of at most "
        f"{cuda_exec.TABLE_MAX} entries; and the arithmetic transforms on "
        "float32, int32 and bool values, under a sink that is not a NoOp (so "
        "estimate_many runs on executor=None).  Multivariate, marginal, copula and "
        "QuantileTransform nodes, scalar_transform nodes (a Python function), and "
        "path processes and their functionals ((n, steps) values), run on "
        "executor=None."
    )


def _sample_cuda(plan, size, random_state, method, correlator, gc_strategy):
    from probabilit_tpu_torch.engine import cuda_exec

    sink = plan.sink
    keep_ids = (
        None
        if gc_strategy is None
        else frozenset({sink._id} | {node._id for node in gc_strategy})
    )
    if (
        method is not None
        or keep_ids is None
        or not cuda_exec.supports(plan, keep_ids)
    ):
        raise ValueError(cuda_limits())
    if plan.corr_matrix is not None:
        resolved = _compile.resolve_correlator(correlator)
        ic_cls = _compile.CORRELATOR_MAP["imanconover"]
        if not (resolved is ic_cls or type(resolved) is ic_cls):
            # The kernel's correlation induction IS (sort-free)
            # Iman-Conover; other correlators have other semantics.
            raise ValueError("executor='cuda' supports correlator='imanconover' only.")
    env_issue = cuda_exec.environment_issue()
    if env_issue is not None:
        raise ValueError(env_issue)
    timer = _profiling.PhaseTimer() if _profiling.profiling_enabled() else None
    device = config.device()
    seed = resolve_seed(random_state)
    _clear_samples(plan)
    _compile.check_rows(plan, size)
    words = cuda_exec.seed_words(seed)
    keep_order = cuda_exec.keep_order(plan, keep_ids)
    with _phase(timer, "build+compile", device):
        tape = cuda_exec.lowered(plan, keep_order, device)
        if timer is not None and tape.code.device.type == "cuda":
            tape.kernel  # the nvcc build at first use, inside the phase
    with _phase(timer, "execute", device):
        ab = None
        if plan.corr_matrix is not None:
            ab = cuda_exec.recolor_transform(plan, words, size, device=device)
        out, nonfinite = cuda_exec.run(tape, words, size, ab)
    with _phase(timer, "host", device):
        with _profiling.span("probabilit.wait"):
            bad = nonfinite.item()
        if bad:
            raise ValueError("Sampling produced non-finite values.")
        by_id = {node._id: node for node in plan.topo}
        for k, nid in enumerate(keep_order):
            by_id[nid].samples_ = out[k]
    _report(timer)
    return sink.samples_


def sample_from_quantiles(sink, quantiles, correlator="imanconover", gc_strategy=None):
    """Sample the graph from an explicit ``(n, d)`` quantile matrix.

    Quantiles are clamped to the open unit interval before the ppf
    functions (``ops/qmc.clamp_open_unit``), so an exact 0 or 1 yields the
    most extreme finite draw.
    """
    plan = _compile.get_plan(sink)
    quantiles = torch.as_tensor(
        quantiles, dtype=config.float_dtype(), device=config.device()
    )
    if quantiles.ndim != 2:
        raise ValueError("`quantiles` must have shape (num_samples, dimensionality)")
    quantiles = _qmc.clamp_open_unit(quantiles)
    _, n_dim = quantiles.shape
    if n_dim != plan.d_total:
        extra = (
            ""
            if plan.d_total == plan.d
            else f" ({plan.d} scalar columns + {plan.d_total - plan.d} path-driver columns)"
        )
        raise ValueError(
            f"`quantiles` has {n_dim} columns but the graph has "
            f"{plan.d_total} sampling dimensions{extra}."
        )
    return _execute(plan, quantiles, correlator, gc_strategy)


def _execute(plan, quantiles, correlator, gc_strategy, generated=False, drawn=False):
    timer = _profiling.PhaseTimer() if _profiling.profiling_enabled() else None
    device = _mesh.home_device()

    # Clear any stale samples before running, so a failure leaves none.
    _clear_samples(plan)

    if gc_strategy is None:
        keep_ids = frozenset(node._id for node in plan.topo)
    else:
        keep_ids = frozenset({plan.sink._id} | {node._id for node in gc_strategy})

    with _phase(timer, "build+compile", device):
        body = _compile.build_body(plan, keep_ids, correlator, generated=generated, drawn=drawn)
    with _phase(timer, "execute", device):
        outputs = _compile.map_quantiles(plan, body, quantiles, drawn)

    with _phase(timer, "host", device):
        # Non-finite guard: one fused flag (one device sync), then the
        # offending node is named.
        floats = {
            nid: v
            for nid, v in outputs.items()
            if v is not None and v.is_floating_point()
        }
        if floats:
            finite = torch.stack([torch.isfinite(v).all() for v in floats.values()]).all()
            with _profiling.span("probabilit.wait"):
                finite = finite.item()
            if not finite:
                by_id = {node._id: node for node in plan.topo}
                for nid, value in floats.items():
                    if not torch.isfinite(value).all():
                        raise ValueError(
                            f"Sampling this node gave non-finite values: "
                            f"{by_id[nid]}\n{value}"
                        )

        # Host finalizers: a string-valued DiscreteDistribution's values.
        for nid, fn in plan.finalizers.items():
            if nid in outputs:
                outputs[nid] = fn(outputs[nid])

        for node in plan.topo:
            if node._id in outputs:
                node.samples_ = outputs[node._id]
    _report(timer)
    return plan.sink.samples_
