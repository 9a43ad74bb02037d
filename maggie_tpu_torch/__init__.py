"""maggie_tpu_torch: the PyTorch / CUDA (Hopper, sm_90a) port of ``maggie_tpu``.

The JAX package ``maggie_tpu`` is the reference; this package imports nothing
from it (nor JAX). Modules mirror the JAX package's file names. Each Pallas
kernel of the reference has a hand-written CUDA kernel under ``ops/kernels``
with a plain PyTorch twin beside it; the twin runs only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .config import ConfigNode, default_config, load_config
from .device import resolve_device

__all__ = ["ConfigNode", "default_config", "load_config", "resolve_device"]
