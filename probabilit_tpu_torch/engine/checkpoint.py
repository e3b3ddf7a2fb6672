"""Checkpoint / resume of sampled graph state.

Port of ``probabilit_tpu/engine/checkpoint.py``.  The sampled state of a
graph is ``{node_position: samples}`` plus a structural fingerprint, so it
can be saved and restored across processes.  Restoring matches nodes by
their position in the deterministic topological order, so a structurally
identical graph built in a fresh process (where raw ``_id`` values differ)
restores correctly; the fingerprint refuses a restore onto a graph that
differs from the one saved.  Samples are saved as numpy arrays and come
back as tensors on ``config.device()`` (string samples, which a string
``DiscreteDistribution`` gives, as numpy arrays).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from probabilit_tpu_torch import config
from probabilit_tpu_torch.models.graph import topological_sort

__all__ = ["state_dict", "load_state_dict", "save", "load", "graph_fingerprint"]

_FINGERPRINT_KEY = "__fingerprint__"


def graph_fingerprint(sink):
    """Cross-process-stable structural hash of ``sink``'s graph: each
    node's static signature and its parents' topological positions (raw
    ``_id`` values are process-local and left out).  A scalar function
    transform signs by its function's ``__qualname__``: ``id(func)`` does
    not survive a process boundary."""
    topo = topological_sort(sink)
    position = {node._id: pos for pos, node in enumerate(topo)}
    lines = []
    for node in topo:
        sig = node._static_signature()
        if sig and sig[0] == "ScalarFunctionTransform":
            fn = getattr(node, "func", None)
            sig = (sig[0], getattr(fn, "__qualname__", "<callable>")) + tuple(sig[2:])
        lines.append(repr((sig, tuple(position[p._id] for p in node.get_parents()))))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def state_dict(sink):
    """Sampled state: topological position -> samples (numpy, or None),
    with the graph's fingerprint under ``"__fingerprint__"``."""
    state = {_FINGERPRINT_KEY: graph_fingerprint(sink)}
    for pos, node in enumerate(topological_sort(sink)):
        if hasattr(node, "samples_"):
            value = node.samples_
            state[pos] = None if value is None else _host(value)
    return state


def load_state_dict(sink, state):
    """Restore ``samples_`` onto the graph from a state dict.

    Raises ``ValueError`` if the state carries a fingerprint that does not
    match ``sink``'s graph (restoring by position onto a different graph
    would assign samples to the wrong nodes).
    """
    state = dict(state)
    saved_fp = state.pop(_FINGERPRINT_KEY, None)
    if saved_fp is not None and str(saved_fp) != graph_fingerprint(sink):
        raise ValueError(
            "Checkpoint fingerprint mismatch: this state was saved from a "
            "structurally different graph and cannot be restored by "
            "topological position."
        )
    topo = topological_sort(sink)
    for node in topo:
        if hasattr(node, "samples_"):
            delattr(node, "samples_")
    for pos, value in state.items():
        if value is not None and np.asarray(value).dtype.kind in "biuf":
            value = torch.as_tensor(np.asarray(value), device=config.device())
        topo[int(pos)].samples_ = value
    return sink


def save(sink, path):
    """Save sampled graph state to an ``.npz`` file."""
    state = state_dict(sink)
    fingerprint = state.pop(_FINGERPRINT_KEY)
    arrays = {}
    none_positions = []
    for pos, value in state.items():
        if value is None:
            none_positions.append(pos)
        else:
            arrays[f"node_{pos}"] = value
    np.savez_compressed(
        path,
        __none_positions__=np.asarray(none_positions, dtype=np.int64),
        **{_FINGERPRINT_KEY: np.asarray(fingerprint)},
        **arrays,
    )
    return path


def load(sink, path):
    """Load sampled graph state from an ``.npz`` file onto ``sink``'s graph."""
    with np.load(path, allow_pickle=False) as data:
        state = {}
        for name in data.files:
            if name == "__none_positions__":
                for pos in data[name]:
                    state[int(pos)] = None
            elif name == _FINGERPRINT_KEY:
                state[_FINGERPRINT_KEY] = str(data[name])
            else:
                state[int(name.removeprefix("node_"))] = data[name]
    return load_state_dict(sink, state)
