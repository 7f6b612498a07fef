"""The (channel, block) mesh, its collectives, the sharded chain and the
multi-process mesh (the JAX package's ``parallel/``)."""
from .mesh import (
    BLOCK_AXIS,
    CHANNEL_AXIS,
    DeviceMesh,
    ProcessGrid,
    build_mesh,
    shard_signal,
    single_device_mesh,
    unshard_signal,
)
from .pipeline import ShardPlan, build_sharded_pipeline, run_sharded

__all__ = ["BLOCK_AXIS", "CHANNEL_AXIS", "DeviceMesh", "ProcessGrid",
           "ShardPlan", "build_mesh", "build_sharded_pipeline",
           "run_sharded", "shard_signal", "single_device_mesh",
           "unshard_signal"]
