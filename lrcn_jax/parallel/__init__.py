from lrcn_jax.parallel.mesh import make_mesh, mesh_from_config
from lrcn_jax.parallel.pipeline import (
    PipelinedTrainStep,
    from_pipeline_params,
    to_pipeline_params,
)
from lrcn_jax.parallel.train import (
    ShardedTrainStep,
    batch_sharding,
    param_sharding,
    shard_params,
)

__all__ = [
    "make_mesh",
    "mesh_from_config",
    "ShardedTrainStep",
    "PipelinedTrainStep",
    "to_pipeline_params",
    "from_pipeline_params",
    "batch_sharding",
    "param_sharding",
    "shard_params",
]
