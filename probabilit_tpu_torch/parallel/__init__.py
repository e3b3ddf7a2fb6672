"""Parallelism: device meshes and sample-axis sharding."""

from probabilit_tpu_torch.parallel.mesh import (  # noqa: F401
    SAMPLE_AXIS,
    Mesh,
    current_mesh,
    make_mesh,
    sample_sharding,
    set_mesh,
    shard_samples,
    use_mesh,
)
