"""Parallelism over a ``torch.distributed`` world, one process per card
(port of ``simseg_tpu/parallel``: its mesh and collectives, data
parallelism, the sharded-state legs: tensor and sequence parallelism,
FSDP, expert parallelism and ZeRO-1, ``tp.py`` and ``sharding.py``, and
pipeline parallelism, ``pp.py``).

JAX's public table (``simseg_tpu/parallel/__init__.py``) and the port's
own names, each imported from its submodule on first use, so ``import
simseg_tpu_torch.parallel`` imports no submodule. JAX names with no
counterpart (``NO_COUNTERPART``), all of them ``jax.sharding`` objects or
placements of a single-controller program, where a port process holds only
its own rank's tensors:

- ``DATA_AXIS``, ``MODEL_AXIS``, ``PIPE_AXIS``, ``REPLICA_AXIS``,
  ``batch_axes``: the names of a ``jax.sharding.Mesh``'s axes; the port's
  ``DataMesh`` holds the process groups of those axes;
- ``data_sharding``, ``replicated``, ``tp_shardings``, ``ep_shardings``:
  ``NamedSharding``s; the port's per-tensor layout is ``tp.ParamSpec``
  (``sharding.plan_specs``);
- ``shard_batch``: a host batch put over the mesh; each port process loads
  its own shard (``data/datasets.process_shard``);
- ``place_params_tp``: parameters put by the TP shardings; the port's
  ``sharding.shard_model`` cuts each rank's parameters;
- ``stack_block_params``: the blocks' parameters stacked for JAX's scan
  over stages; a port stage runs its own blocks (``pp.py``).
"""

from simseg_tpu_torch import lazy_package

_PUBLIC = {name: (f"simseg_tpu_torch.parallel.{module}", name)
           for module, names in (
               ("collectives", ("all_gather", "all_reduce_max",
                                "all_reduce_mean", "all_reduce_sum",
                                "allgather_rows", "axis_index", "barrier",
                                "broadcast_object", "process_allgather",
                                "reduce_gradients")),
               ("mesh", ("DataMesh", "batch_shards", "init_distributed",
                         "is_distributed", "local_batch_size", "local_rank",
                         "loss_group_samples", "make_mesh", "rank",
                         "world_size")),
               ("pp", ("make_pp_forward", "pipeline_blocks",
                       "pp_image_tokens", "pp_text_feature")),
               ("sharding", ("full_state_dict", "load_full_state_dict",
                             "shard_model")),
           ) for name in names}
NO_COUNTERPART = ("DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "REPLICA_AXIS",
                  "batch_axes", "data_sharding", "replicated", "tp_shardings",
                  "ep_shardings", "shard_batch", "place_params_tp",
                  "stack_block_params")
__all__ = sorted(_PUBLIC)
__getattr__, __dir__ = lazy_package(__name__, _PUBLIC)
