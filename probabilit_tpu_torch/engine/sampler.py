"""Sampling orchestration: the public ``.sample()`` entry point.

Port of ``probabilit_tpu/engine/sampler.py:45-257``.  Two executors:

* ``executor=None``: the plain PyTorch executor on ``config.device()``.
  Uniforms come from a ``torch.Generator`` seeded by ``random_state``, and
  ``engine/compile.py::build_body`` evaluates the graph op by op.
* ``executor="cuda"``: the whole graph in one CUDA kernel
  (``engine/cuda_exec.py``), with Philox4x32-10 bits drawn inside it.
  The counterpart of the JAX package's ``executor="pallas"``.

The two executors draw different random streams; each is deterministic
per seed.
"""

from __future__ import annotations

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.engine import compile as _compile
from probabilit_tpu_torch.ops import qmc as _qmc

__all__ = ["sample", "sample_from_quantiles", "resolve_seed"]


def resolve_seed(random_state):
    """Map ``random_state`` (None, an int, or a numpy ``Generator``) to an
    integer seed: None draws fresh entropy, a ``Generator`` is advanced."""
    if random_state is None:
        return int(np.random.SeedSequence().entropy % (2**63))
    if isinstance(random_state, (int, np.integer)):
        return int(random_state)
    if isinstance(random_state, np.random.Generator):
        return int(random_state.integers(2**63))
    raise TypeError(f"Cannot interpret random_state: {random_state!r}")


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
    size = 1 if size is None else int(size)
    plan = _compile.get_plan(sink)

    if executor == "pallas":
        raise ValueError(
            "executor='pallas' is the JAX package's TPU megakernel; the "
            "port's counterpart is executor='cuda'."
        )
    if executor == "cuda":
        return _sample_cuda(plan, size, random_state, method, gc_strategy)
    if executor is not None:
        raise ValueError(f"Unknown executor {executor!r}; use None or 'cuda'.")
    if method is not None:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (QMC: ROADMAP A9); "
            "use method=None."
        )
    gen = torch.Generator(device=config.device())
    gen.manual_seed(resolve_seed(random_state))
    quantiles = torch.rand(
        (size, plan.d),
        generator=gen,
        dtype=config.float_dtype(),
        device=config.device(),
    )
    return _execute(plan, _qmc.clamp_open_unit(quantiles), gc_strategy)


def _sample_cuda(plan, size, random_state, method, gc_strategy):
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
        raise ValueError(
            "executor='cuda' requires method=None, a narrow gc_strategy "
            "keep-list (<= 16 kept nodes; [] keeps just the sink), an "
            "uncorrelated graph, and the families uniform, norm, expon, "
            "lognorm and triang, without integer or boolean arithmetic."
        )
    env_issue = cuda_exec.environment_issue()
    if env_issue is not None:
        raise ValueError(env_issue)
    seed = resolve_seed(random_state)
    _clear_samples(plan)
    keep_order = cuda_exec.keep_order(plan, keep_ids)
    tape = cuda_exec.lower(plan, keep_order).to(config.device())
    out, nonfinite = cuda_exec.run(tape, cuda_exec.seed_words(seed), size)
    if nonfinite.item():
        raise ValueError("Sampling produced non-finite values.")
    by_id = {node._id: node for node in plan.topo}
    for k, nid in enumerate(keep_order):
        by_id[nid].samples_ = out[k]
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
        raise ValueError(
            f"`quantiles` has {n_dim} columns but the graph has "
            f"{plan.d_total} sampling dimensions."
        )
    return _execute(plan, quantiles, gc_strategy)


def _execute(plan, quantiles, gc_strategy):
    # Clear any stale samples before running, so a failure leaves none.
    _clear_samples(plan)

    if gc_strategy is None:
        keep_ids = frozenset(node._id for node in plan.topo)
    else:
        keep_ids = frozenset({plan.sink._id} | {node._id for node in gc_strategy})

    outputs = _compile.build_body(plan, keep_ids)(quantiles)

    # Non-finite guard: one fused flag (one device sync), then the
    # offending node is named.
    floats = {
        nid: v
        for nid, v in outputs.items()
        if v is not None and v.is_floating_point()
    }
    if floats and not torch.stack(
        [torch.isfinite(v).all() for v in floats.values()]
    ).all().item():
        by_id = {node._id: node for node in plan.topo}
        for nid, value in floats.items():
            if not torch.isfinite(value).all():
                raise ValueError(
                    f"Sampling this node gave non-finite values: "
                    f"{by_id[nid]}\n{value}"
                )

    for node in plan.topo:
        if node._id in outputs:
            node.samples_ = outputs[node._id]
    return plan.sink.samples_
