"""Prefetched host-to-device infeed for the train loop (port of
``maggie_tpu/engine/infeed.py``; the reference overlaps the copy with compute
through its DataLoader's ``pin_memory`` and CUDA streams,
``maggie/engine/train.py:211-233``).

A background thread takes each host batch from the loader and copies its
train tensors (``image``, ``mask``, ``alpha``, ``transition``) to the model's
device: on the card through pinned host tensors, on a side CUDA stream, with
an event recorded after the copies. The consumer's stream waits on that event
(the host does not), and each device tensor is marked with
``record_stream`` for the consumer's stream, so that the caching allocator does
not hand its memory to the side stream's next copies while the step still
reads it. ``depth`` batches are in flight at most. On the CPU the batches are
plain tensors.

The JAX package packs every tensor of a batch into one f32 buffer: that is a
workaround for a TPU link's fixed cost per transfer, and is not copied.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

TRAIN_KEYS = ("image", "mask", "alpha", "transition")

_SENTINEL = object()


class DeviceInfeed:
    """Iterator of ``(host_batch, device_batch)``.

    ``close()`` stops the producer thread and drops the prefetched batches;
    the train loop calls it in a ``finally`` so that an aborted run leaves no
    thread decoding and no batches held on the card. Once the host iterator
    has raised, every later ``next()`` raises the same error."""

    def __init__(self, host_iter: Iterator[dict], device: torch.device, depth: int = 2):
        self.host_iter = host_iter
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._final: BaseException | None = None
        self._done = False
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, batch: dict) -> tuple[dict, torch.cuda.Event | None]:
        host = {k: torch.from_numpy(np.ascontiguousarray(batch[k], dtype=np.float32))
                for k in TRAIN_KEYS if k in batch}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return dev, ready

    def _produce(self):
        try:
            if self._stream is not None:
                # this thread's current card is the infeed's (a rank's own
                # under data parallelism): pinned buffers and copies make no
                # context on another card
                torch.cuda.set_device(self.device)
            for batch in self.host_iter:
                if self._stop.is_set():
                    return
                self._enqueue((batch, *self._put(batch)))
                if self._stop.is_set():
                    return
            self._enqueue(_SENTINEL)
        except BaseException as exc:  # the consumer re-raises it
            self._enqueue(exc)

    def _enqueue(self, item):
        # a bounded put that gives up on close() instead of blocking forever
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the producer and drop the prefetched batches, also one it put
        while stopping; then close the host iterator (a loader's stops its
        own thread). Idempotent."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=10.0)
        self._drain()
        if not self._thread.is_alive() and hasattr(self.host_iter, "close"):
            self.host_iter.close()

    def __iter__(self):
        return self

    def __next__(self) -> tuple[dict, dict]:
        if self._done:
            if self._final is not None:
                raise self._final
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            self._final = item
            raise item
        batch, dev, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for v in dev.values():
                v.record_stream(stream)
        return batch, dev
