"""Parallelism over a ``torch.distributed`` world, one process per card
(port of ``simseg_tpu/parallel``: its mesh and collectives, data
parallelism, and the sharded-state legs: tensor and sequence parallelism,
FSDP and ZeRO-1, ``tp.py`` and ``sharding.py``; PP and expert parallelism
are not ported, ROADMAP queue 1 item 13)."""

from simseg_tpu_torch.parallel.collectives import (all_gather, all_reduce_max,
                                                   all_reduce_mean,
                                                   all_reduce_sum,
                                                   allgather_rows, axis_index,
                                                   barrier, broadcast_object,
                                                   process_allgather,
                                                   reduce_gradients)
from simseg_tpu_torch.parallel.mesh import (DataMesh, batch_shards,
                                            init_distributed, is_distributed,
                                            local_batch_size, local_rank,
                                            loss_group_samples, make_mesh,
                                            rank, world_size)
from simseg_tpu_torch.parallel.sharding import (full_state_dict,
                                                load_full_state_dict,
                                                shard_model)

__all__ = ["DataMesh", "all_gather", "all_reduce_max", "all_reduce_mean",
           "all_reduce_sum", "allgather_rows", "axis_index", "barrier",
           "batch_shards", "broadcast_object", "full_state_dict",
           "init_distributed", "is_distributed", "load_full_state_dict",
           "local_batch_size", "local_rank", "loss_group_samples", "make_mesh",
           "process_allgather", "rank", "reduce_gradients", "shard_model",
           "world_size"]
