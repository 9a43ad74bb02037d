"""Data parallelism across cards (``dist.py``): one process per card under
``torchrun``, NCCL on CUDA and gloo on the CPU."""

from .dist import (all_reduce_grads, all_reduce_sum, backend, barrier, check_same, destroy,
                   global_max, global_mean, global_sum, host_all_reduce, init_from_env,
                   launched, local_world, rank, rank_batch_size, shard_draw, shard_rows,
                   sum_values, world)

__all__ = ["all_reduce_grads", "all_reduce_sum", "backend", "barrier", "check_same", "destroy",
           "global_max", "global_mean", "global_sum", "host_all_reduce", "init_from_env",
           "launched", "local_world", "rank", "rank_batch_size", "shard_draw", "shard_rows",
           "sum_values", "world"]
