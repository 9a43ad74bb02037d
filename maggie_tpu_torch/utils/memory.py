"""Device memory counter (port of ``maggie_tpu/utils/memory.py``; the
reference logs ``torch.cuda.max_memory_allocated``, ``maggie/engine/test.py:155-156``)."""

from __future__ import annotations

import torch


def device_peak_memory_mb(device: str | torch.device | None = None) -> float | None:
    """Peak bytes allocated by PyTorch on the CUDA ``device`` (the current one
    when None), in MB; None when the run is on the CPU or CUDA was never used."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated(dev) / (1024.0 * 1024.0)
