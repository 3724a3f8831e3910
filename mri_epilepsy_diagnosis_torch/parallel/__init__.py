from .sharding import (all_reduce, batch_sharding, check_shard_divisibility,
                       current_mesh, gather, halo_exchange,
                       make_parallel_apply, replicate, shard_batch,
                       use_mesh, volume_sharding)

__all__ = ["all_reduce", "batch_sharding", "check_shard_divisibility",
           "current_mesh", "gather", "halo_exchange", "make_parallel_apply",
           "replicate", "shard_batch", "use_mesh", "volume_sharding"]
