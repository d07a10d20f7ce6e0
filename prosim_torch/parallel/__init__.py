from prosim_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
