"""Host data loader for eval: per-process sharding, batching, background
prefetch (port of ``maggie_tpu/data/loader.py``; its training options,
shuffling, ``drop_last`` and endless epochs, come with training, ROADMAP item
10).

Each process takes a strided shard of the index space; a daemon thread keeps a
small prefetch queue warm so host decoding overlaps device compute. An error in
that thread is raised by the iterator (the JAX package's loader ends the epoch
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
    def __init__(self, dataset, batch_size: int = 1, num_shards: int = 1,
                 shard_index: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch

    def _indices(self) -> np.ndarray:
        return np.arange(len(self.dataset))[self.shard_index::self.num_shards]

    def __len__(self) -> int:
        return (len(self._indices()) + self.batch_size - 1) // self.batch_size

    def _produce(self, q: queue.Queue):
        idx = self._indices()
        try:
            for i in range(0, len(idx), self.batch_size):
                q.put(_collate([self.dataset[int(j)] for j in idx[i:i + self.batch_size]]))
        except Exception as exc:  # the consumer re-raises it
            q.put(exc)
            return
        q.put(None)

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is None:
                return
            if isinstance(b, Exception):
                raise b
            yield b
