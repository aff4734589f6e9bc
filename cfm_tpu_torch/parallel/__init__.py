"""Data parallelism on ``torch.distributed``: process groups, device meshes,
per-rank batches (counterpart of ``cfm_tpu/parallel``)."""

from .mesh import (data_parallel_sharding, initialize_distributed, local_coupling_step, make_mesh,
                   replicated_sharding, shard_batch_per_host)

__all__ = [
    "data_parallel_sharding",
    "initialize_distributed",
    "local_coupling_step",
    "make_mesh",
    "replicated_sharding",
    "shard_batch_per_host",
]
