"""Device meshes for the streams (parallel/mesh.py): 1x1 only for now."""
from .mesh import (
    BLOCK_AXIS,
    CHANNEL_AXIS,
    DeviceMesh,
    build_mesh,
    single_device_mesh,
)

__all__ = ["BLOCK_AXIS", "CHANNEL_AXIS", "DeviceMesh", "build_mesh",
           "single_device_mesh"]
