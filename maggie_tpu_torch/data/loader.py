"""Host data loader: per-process sharding, batching, shuffling, background
prefetch (port of ``maggie_tpu/data/loader.py``).

Each process takes a strided shard of the index space, reshuffled from the
loader's own ``RandomState(seed)`` at every epoch when ``shuffle``; a daemon
thread keeps a small prefetch queue warm so host decoding overlaps device
compute, and with ``infinite`` it runs epoch after epoch. An error in that
thread is raised by the iterator (the JAX package's loader ends the epoch
early instead, ``maggie_tpu/data/loader.py:84-85``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], torch.Tensor):
            # device-preprocessed tensors: stack where they are
            out[k] = torch.stack(vals, dim=0)
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            out[k] = np.asarray(vals)
        elif (isinstance(vals[0], list) and vals[0]
              and isinstance(vals[0][0], str)):
            # torch default_collate turns a list of string-lists into a list over
            # the inner index of per-batch tuples; engine code indexes that way
            out[k] = [tuple(v) for v in zip(*vals)]
        else:
            out[k] = vals  # transform_info etc: batch-major list
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0, prefetch: int = 2, infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.infinite = infinite

    def _indices(self) -> np.ndarray:
        """This shard's indices of the next epoch (a shuffle draws from ``rng``)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        """This shard's batches an epoch (the JAX package's loader counts a
        shuffled shard as the largest one)."""
        n = len(range(self.shard_index, len(self.dataset), self.num_shards))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> Iterator[dict]:
        idx = self._indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield _collate([self.dataset[int(j)] for j in chunk])

    def _produce(self, q: queue.Queue, stop: threading.Event):
        try:
            while True:
                for b in self._epoch_batches():
                    if stop.is_set():
                        return
                    q.put(b)
                if not self.infinite:
                    break
        except Exception as exc:  # the consumer re-raises it
            q.put(exc)
            return
        q.put(None)

    def __iter__(self) -> Iterator[dict]:
        """Batches from a producer thread. Closing the iterator (or dropping
        it) stops that thread after the batch it is making."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    return
                if isinstance(b, Exception):
                    raise b
                yield b
        finally:
            stop.set()
            while not q.empty():   # a put that waits for room returns
                q.get_nowait()
