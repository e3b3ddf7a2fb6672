"""Sample-axis sharding over a device mesh, in PyTorch.

Port of ``probabilit_tpu/parallel/mesh.py``.  The scale axis of Monte
Carlo is the sample axis: every node's rows split over the mesh's
``samples`` axis, transforms are row by row, and only the steps that need
other rows (a correlator's statistics and ranks, a fold into an estimate,
a Gram sum, a quantile) bring shards together.

A mesh is a tuple of ``torch.device`` s, one per shard, on the one axis
``"samples"``.  An entry may repeat: ``[torch.device("cpu")] * 8`` is eight
shards on the CPU, ``[torch.device("cuda:0")] * 4`` four shards on one
card.  That is the port's counterpart of the eight virtual CPU devices
the JAX package's tests run on (XLA's
``--xla_force_host_platform_device_count``): it lets the sharded code run,
and be held against the unsharded code, on a machine with one card or
none.

One PyTorch process has no SPMD partitioner, so the engine does what XLA
does from the JAX package's annotations (``engine/compile.map_quantiles``):
each shard computes its own rows of every row-wise step on its own
device; a step that needs other shards' rows reads them, or their partial
sums, on ``mesh.devices[0]``; results come back as one tensor there.
Shard ``s`` holds rows ``[s*c, min(n, (s+1)*c))``, ``c = ceil(n / size)``.

Usage::

    mesh = make_mesh()                  # every CUDA card, axis "samples"
    with use_mesh(mesh):
        node.sample(1_000_000, random_state=0)
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from probabilit_tpu_torch import config

__all__ = [
    "SAMPLE_AXIS",
    "Mesh",
    "make_mesh",
    "use_mesh",
    "set_mesh",
    "current_mesh",
    "sample_sharding",
    "shard_samples",
]

SAMPLE_AXIS = "samples"

_ACTIVE_MESH = None


class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard (entries may repeat)."""

    def __init__(self, devices, axis_names=(SAMPLE_AXIS,)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("A mesh needs at least one device.")
        self.axis_names = tuple(axis_names)

    @property
    def size(self):
        return len(self.devices)

    @property
    def device_set(self):
        return set(self.devices)

    def __repr__(self):
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.axis_names[0]!r}: {self.size}, devices=[{names}])"


class RowSharding:
    """``sample_sharding``'s record: axis 0 of an ``ndim`` value split over
    ``mesh``'s shards (the counterpart of a ``NamedSharding`` whose
    ``PartitionSpec`` names the sample axis first)."""

    def __init__(self, mesh, ndim):
        self.mesh = mesh
        self.ndim = ndim

    @property
    def device_set(self):
        return self.mesh.device_set

    def bounds(self, n):
        """Shard s's rows ``[start, stop)`` of an axis of ``n``."""
        return row_bounds(n, self.mesh.size)

    def __repr__(self):
        return f"RowSharding({self.mesh!r}, ndim={self.ndim})"


def make_mesh(devices=None, axis_name=SAMPLE_AXIS):
    """1-D mesh over ``devices`` (default: every CUDA card) with a sample
    axis.  Without ``devices`` the sampling device must be a card: the
    mesh never falls back to the CPU."""
    if devices is None:
        dev = config.device()
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise ValueError(
                f"make_mesh() takes every CUDA card, but config.device() is "
                f"{str(dev)!r} (torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}); pass devices= for another mesh, "
                "e.g. [torch.device('cpu')] * 8."
            )
        devices = [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


def set_mesh(mesh):
    """Set (or clear, with None) the process-wide sampling mesh."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    return mesh


def current_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Context manager scoping the sampling mesh."""
    previous = current_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(previous)


def sample_sharding(ndim=2, mesh=None):
    """Axis 0 (samples) split over the mesh, or None without a mesh or
    for a 0-d value (no sample axis: leave its placement alone)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or ndim < 1:
        return None
    return RowSharding(mesh, ndim)


def shard_samples(array, mesh=None):
    """``array``'s leading-axis row blocks, each on its shard's device.

    A 0-d value, or any value without a mesh, comes back unchanged.  As
    ``jax.device_put`` does, a leading axis the mesh does not divide is
    refused; the engine's own splits (``split_rows``) allow uneven ones.
    """
    sharding = sample_sharding(np.ndim(array), mesh)
    if sharding is None:
        return array
    x = torch.as_tensor(array)
    n, size = x.shape[0], sharding.mesh.size
    if n % size:
        raise ValueError(
            f"shard_samples: the sample axis of {size} shards implies that "
            f"dimension 0 should be divisible by {size}, but it is equal to {n} "
            f"(full shape: {tuple(x.shape)})."
        )
    return split_rows(x, sharding.mesh)


def row_bounds(n, size):
    """``[start, stop)`` of each of ``size`` shards of ``n`` rows:
    ``c = ceil(n / size)`` rows a shard, the last ones short or empty."""
    c = -(-int(n) // size)
    return [(min(n, s * c), min(n, (s + 1) * c)) for s in range(size)]


def split_rows(x, mesh, axis=0):
    """``x``'s blocks along ``axis``, shard s's on ``mesh.devices[s]``."""
    return tuple(
        x.narrow(axis, lo, hi - lo).to(dev)
        for (lo, hi), dev in zip(row_bounds(x.shape[axis], mesh.size), mesh.devices)
    )


def home_device(mesh=None):
    """Where results land: ``mesh.devices[0]``, or ``config.device()``
    without a mesh."""
    mesh = current_mesh() if mesh is None else mesh
    return config.device() if mesh is None else mesh.devices[0]


def gather_rows(parts, rows, device, axis=0):
    """Shards' outputs -> one value on ``device``: a tensor whose ``axis``
    has the shard's row count is concatenated (``.to`` and ``cat`` are
    differentiable), dicts, tuples and lists recursively, anything else
    (a 0-d value, None) is shard 0's."""
    first = parts[0]
    if isinstance(first, dict):
        return {
            k: gather_rows([p[k] for p in parts], rows, device, axis) for k in first
        }
    if isinstance(first, (tuple, list)):
        return type(first)(
            gather_rows([p[i] for p in parts], rows, device, axis)
            for i in range(len(first))
        )
    if (
        isinstance(first, torch.Tensor)
        and first.ndim >= 1
        and first.shape[axis] == rows[0]
        and all(p.shape[axis] == r for p, r in zip(parts, rows))
    ):
        return torch.cat([p.to(device) for p in parts], dim=axis)
    if isinstance(first, torch.Tensor):
        return first.to(device)
    return first


def map_rows(fn, x, mesh, axis=0):
    """``fn`` on each non-empty row block of ``x`` (a tensor, or blocks
    already split as ``split_rows`` splits them), on its shard's device;
    the outputs gathered on ``mesh.devices[0]`` along ``axis``."""
    blocks = x if isinstance(x, (tuple, list)) else split_rows(x, mesh)
    blocks = [b for b in blocks if b.shape[0] > 0] or list(blocks[:1])
    return gather_rows([fn(b) for b in blocks], [b.shape[0] for b in blocks],
                       mesh.devices[0], axis)
