"""Data parallelism: one process per card, launched by ``torchrun`` (the
port's counterpart of the ``data`` axis of ``maggie_tpu/parallel/mesh.py``).

The JAX package shards the batch over a ``data`` mesh axis inside one jit,
and XLA makes every reduction of the step global: the BatchNorm statistics,
the loss denominators, the batch-wide flags and the gradients. Here each rank
holds contiguous rows of the global batch (``shard_rows``), and the model
makes those reductions global by hand through these helpers:

- ``all_reduce_sum``: a sum over the ranks that autograd differentiates. Every
  rank's loss term reads the sum, so its backward sums the incoming gradients
  over the ranks;
- ``global_sum``, ``global_max``, ``global_mean``: detached, for counts,
  denominators and flags, on the device (no host read);
- ``shard_draw``: a random draw of the global batch's shape from the step's
  generator, of which the rank keeps its rows, so that a rank draws what one
  process draws for its rows of the global batch;
- ``all_reduce_grads``: the gradients summed over the ranks in buckets;
- ``check_same``, ``host_all_reduce``, ``barrier``: host values over a gloo
  group beside NCCL, which never waits on the card.

Under row sharding (``space.py``) the world is ``data x space``: global rank
``d * space + s`` holds band ``s`` of the rows of data shard ``d``'s frames.
Sums of banded tensors and their counts run over every rank, as above (the
bands are equal). A replicated stage (``replicated()``), which every space
rank of a data shard runs on the whole frame, sums its batch statistics
over every rank too, at the world's count: the ``space`` copies' mean is
the data shards' mean, equal on every rank even where the card's convs
round the copies apart. Its draws (``shard_draw``) go by data rank.

Every helper is the identity when no process group is initialised or the
group has one rank: world size 1 runs the single-process code bit for bit.
Nothing falls back: a rank that cannot reach its card raises, and a
collective that outlives the group's timeout fails the run.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

from ..device import resolve_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = timedelta(minutes=10)
# elements of one all-reduce of the gradients (64 MB of f32)
BUCKET_ELEMENTS = 1 << 24

# the gloo group of host values when the default group is NCCL (None: the default)
_host_group = None
# row sharding (space.py): the ranks that split one frame's rows, this rank's
# space group (the bands of its data shard), and whether a replicated stage
# is running
_space = 1
_space_group = None
_replicated = False


def launched() -> bool:
    """True in a process that ``torchrun`` started (its variables are set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device: str | torch.device | None = None, backend: str | None = None,
                  timeout: timedelta = TIMEOUT) -> torch.device:
    """Join the process group that ``torchrun``'s variables describe; returns
    this rank's device. ``device`` is CUDA unless the caller passes "cpu":
    then ``cuda:LOCAL_RANK``, which must exist (no two ranks share a card
    unless the caller names the card, as ``device="cuda:0"``). The backend
    is NCCL on CUDA and gloo on the CPU; ``backend`` overrides it (gloo
    also takes CUDA tensors, and two ranks on one card need it)."""
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set; launch with torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(f"rank {rank}: LOCAL_RANK {local_rank} but this host has "
                                   f"{torch.cuda.device_count()} CUDA devices")
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = dev
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    dist.init_process_group(backend=backend, init_method=address, world_size=world, rank=rank,
                            timeout=timeout, **kwargs)
    global _host_group
    _host_group = dist.new_group(backend="gloo", timeout=timeout) if backend != "gloo" else None
    return dev


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _host_group
    set_groups(1, None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def set_groups(space: int, space_group) -> None:
    """Row sharding's group (``space.init_groups``); ``space`` 1 leaves it."""
    global _space, _space_group
    _space, _space_group = space, space_group


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if _initialized() else 1


def rank() -> int:
    return dist.get_rank() if _initialized() else 0


def space_world() -> int:
    """The ranks that split one frame's rows (1 without row sharding)."""
    return _space


def space_rank() -> int:
    """This rank's band: its index in its space group."""
    return rank() % _space


def space_group():
    return _space_group


def data_world() -> int:
    """The data shards: the world without its space ranks."""
    return world() // _space


def data_rank() -> int:
    return rank() // _space


class replicated:
    """Context of a replicated stage under row sharding: dense convs on the
    whole frame, without halo exchange (``space.conv_rows``)."""

    def __enter__(self):
        global _replicated
        self._outer, _replicated = _replicated, True
        return self

    def __exit__(self, *exc):
        global _replicated
        _replicated = self._outer


def in_replicated() -> bool:
    return _replicated


def backend() -> str | None:
    """The default group's backend ("nccl", "gloo"), None without a group."""
    return dist.get_backend() if _initialized() else None


def local_world() -> int:
    """The ranks on this host (``LOCAL_WORLD_SIZE``); 1 without a group."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if _initialized() else 1


def rank_batch_size(batch_size: int, ranks_on_host: int) -> int:
    """A rank's rows of ``cfg.train.batch_size``, which is one host's batch
    (as in the JAX package, where one process drives a host's devices)."""
    if batch_size % ranks_on_host:
        raise ValueError(f"train.batch_size {batch_size} is one host's batch and must split "
                         f"evenly over its {ranks_on_host} ranks (LOCAL_WORLD_SIZE)")
    return batch_size // ranks_on_host


def shard_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous rows of every tensor of ``batch``."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over {world} ranks")
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: its backward sums the
    incoming gradients over the ranks."""
    return x if world() == 1 else _AllReduceSum.apply(x)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, detached (counts, denominators)."""
    if world() == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y)
    return y


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks, detached."""
    if world() == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``x`` on every rank (the ranks hold equal
    shapes): ``x.mean()`` on one rank, else the local sum over the global
    count, whose sum over the ranks is the global mean."""
    if world() == 1:
        return x.mean()
    return x.sum() / (x.numel() * world())


def shard_draw(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows: ``draw`` of the global batch's
    shape (dim 0 times the data shards), then the rank's rows. Under row
    sharding every draw of the step is per map or per os8 feature, which
    the space ranks of a data shard share: they draw alike."""
    shape = tuple(shape)
    if data_world() == 1:
        return draw(shape)
    n, r = shape[0], data_rank()
    return draw((n * data_world(),) + shape[1:])[r * n:(r + 1) * n]


def all_reduce_grads(params: list[torch.Tensor]) -> None:
    """Sum every ``.grad`` of ``params`` over the ranks in place, in buckets
    of up to ``BUCKET_ELEMENTS`` of one dtype and device."""
    if world() == 1:
        return
    grads = [p.grad for p in params]
    groups: dict = {}
    for g in grads:
        groups.setdefault((g.dtype, g.device), []).append(g)
    for gs in groups.values():
        bucket: list[torch.Tensor] = []
        size = 0
        for g in gs + [None]:
            if g is None or (bucket and size + g.numel() > BUCKET_ELEMENTS):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat)
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
                bucket, size = [], 0
            if g is not None:
                bucket.append(g)
                size += g.numel()


def sum_values(values: dict) -> dict:
    """Each scalar of ``values`` summed over the ranks in one all-reduce
    (the loss terms, whose rank parts sum to the global loss)."""
    if world() == 1 or not values:
        return values
    keys = list(values)
    flat = global_sum(torch.stack([values[k].detach().float().reshape(()) for k in keys]))
    return dict(zip(keys, flat.unbind()))


def host_all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum a CPU tensor over the ranks in place: over the host group, or
    through this rank's card where the only group is NCCL."""
    if world() == 1:
        return t
    if _host_group is None and dist.get_backend() == "nccl":
        on_card = t.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(on_card)
        return t.copy_(on_card.cpu())
    dist.all_reduce(t, group=_host_group)
    return t


def check_same(what: str, value) -> None:
    """Raise unless every rank passes an equal ``value`` (host objects)."""
    if world() == 1:
        return
    seen = [None] * world()
    dist.all_gather_object(seen, value, group=_host_group)
    if any(v != seen[0] for v in seen):
        raise RuntimeError(f"the ranks disagree on {what}: {seen}")


def barrier() -> None:
    """Wait for every rank (on the host; a no-op without a group)."""
    if world() > 1:
        dist.barrier(group=_host_group)
