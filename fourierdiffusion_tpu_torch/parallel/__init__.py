from fourierdiffusion_tpu_torch.parallel.mesh import (
    DataMesh,
    ShardedGenerator,
    auto_data_mesh,
    make_mesh,
    shard_batch,
)

__all__ = [
    "DataMesh",
    "ShardedGenerator",
    "auto_data_mesh",
    "make_mesh",
    "shard_batch",
]
