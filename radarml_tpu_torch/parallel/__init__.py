from radarml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from radarml_tpu_torch.parallel.train_step import make_dp_sgd_train_step

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
    "make_dp_sgd_train_step",
]
