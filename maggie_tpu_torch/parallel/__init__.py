"""Data parallelism across cards (``dist.py``): one process per card under
``torchrun``, NCCL on CUDA and gloo on the CPU; and row sharding of each
frame over a ``space`` group beside the data ranks (``space.py``)."""

from . import space
from .dist import (all_reduce_grads, all_reduce_sum, backend, barrier, check_same, data_rank,
                   data_world, destroy, global_max, global_mean, global_sum, host_all_reduce,
                   in_replicated, init_from_env, launched, local_world, rank, rank_batch_size,
                   replicated, shard_draw, shard_rows, space_rank, space_world, sum_values,
                   world)

__all__ = ["all_reduce_grads", "all_reduce_sum", "backend", "barrier", "check_same", "data_rank",
           "data_world", "destroy", "global_max", "global_mean", "global_sum",
           "host_all_reduce", "in_replicated", "init_from_env", "launched", "local_world", "rank",
           "rank_batch_size", "replicated", "shard_draw", "shard_rows", "space", "space_rank",
           "space_world", "sum_values", "world"]
