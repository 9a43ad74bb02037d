"""Device selection for the port's entry points. torch is imported when a
device is resolved, so that importing the package (the supervisor reads
configs only) loads no torch."""

from __future__ import annotations


def resolve_device(device: str | torch.device | None = None) -> torch.device:  # noqa: F821
    """``None`` means CUDA. Asking for CUDA on a host without it raises: nothing
    falls back to the CPU unless the caller passes ``device="cpu"``."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "maggie_tpu_torch: CUDA was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"maggie_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev
