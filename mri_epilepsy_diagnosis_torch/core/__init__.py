from .device import resolve_device
from .dtypes import BF16_POLICY, DEFAULT_POLICY, Policy
from .mesh import (create_mesh, data_sharding, local_device_count,
                   replicated_sharding)
from .rngs import RngStream, seed_everything

__all__ = [
    "create_mesh", "data_sharding", "replicated_sharding",
    "local_device_count", "seed_everything", "RngStream", "Policy",
    "DEFAULT_POLICY", "BF16_POLICY", "resolve_device",
]
