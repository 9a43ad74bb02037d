"""Haloed patch gather: CUDA kernel wrapper and its plain PyTorch twin.

Port of the TPU kernel ``maggie_tpu/ops/pallas/gather.py::gather_patches_pallas``
(kernel source ``csrc/gather_patches.cu``). Contract, as the JAX package's
``_gather_patches_xla``: ``feat`` (N, H, W, C) -> (cap, S, S, C) with
S = block + 2*halo; patch p covers rows and columns
[b*block - halo, b*block + block + halo) of map ``idx_n[p]``, zeros outside
the map. Forward only: the backward comes with the training slice.

The kernel reads ``feat`` in either of two memory layouts under the logical
(N, H, W, C) shape, and never copies it into another:

- pixel-major: contiguous NHWC (any C=1 map is both);
- plane-major: ``x.permute(0, 2, 3, 1)`` of a contiguous NCHW ``x``, the
  encoder's own layout.

Any other layout raises. The output is always contiguous (cap, S, S, C).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Incremented once per kernel launch (never by the plain twin), so a run can
# show that its path went through the kernel.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the C entry point, set up at first launch


def _entry():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("gather_patches").gather_patches_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def gather_patches_plain(feat: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                         idx_bx: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """Plain PyTorch twin: zero-pad the map by ``halo``, then one advanced-index
    read of every window."""
    size = block + 2 * halo
    padded = F.pad(feat, (0, 0, halo, halo, halo, halo))
    ar = torch.arange(size, device=feat.device)
    ys = (idx_by * block)[:, None] + ar            # (cap, S)
    xs = (idx_bx * block)[:, None] + ar
    return padded[idx_n[:, None, None], ys[:, :, None], xs[:, None, :]]


def feat_strides(feat: torch.Tensor) -> tuple[int, int, int, int]:
    """(n, y, x, c) element strides of a pixel- or plane-major (N, H, W, C) map,
    as the kernel addresses it; ValueError for any other layout."""
    n, h, w, c = feat.shape
    if feat.is_contiguous():
        return h * w * c, w * c, c, 1
    if feat.permute(0, 3, 1, 2).is_contiguous():
        return c * h * w, w, 1, h * w
    raise ValueError(f"gather_patches kernel reads contiguous NHWC or the NHWC view of a "
                     f"contiguous NCHW map, got shape {tuple(feat.shape)} strides "
                     f"{feat.stride()}")


def _launch(feat, idx_n, idx_by, idx_bx, block, halo):
    global launches
    if feat.dtype not in _DTYPES:
        raise TypeError(f"gather_patches kernel takes float32 or bfloat16, not {feat.dtype}")
    if feat.dim() != 4:
        raise ValueError(f"gather_patches kernel needs an (N, H, W, C) map, got "
                         f"shape {tuple(feat.shape)}")
    strides = feat_strides(feat)
    for name, t in (("idx_n", idx_n), ("idx_by", idx_by), ("idx_bx", idx_bx)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != feat.device or t.shape[0] != idx_n.shape[0]:
            raise ValueError(f"{name} must be a contiguous int64 vector of length cap "
                             f"on {feat.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    n, h, w, c = feat.shape
    size = block + 2 * halo
    cap = idx_n.shape[0]
    out = torch.empty((cap, size, size, c), dtype=feat.dtype, device=feat.device)
    fn = _entry()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), idx_n.data_ptr(), idx_by.data_ptr(), idx_bx.data_ptr(),
            out.data_ptr(), _DTYPES[feat.dtype], cap, n, h, w, c, block, halo, *strides,
            stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def gather_patches(feat: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                   idx_bx: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if feat.device.type == "cpu":
        return gather_patches_plain(feat, idx_n, idx_by, idx_bx, block, halo)
    if feat.device.type != "cuda":
        raise ValueError(f"gather_patches runs on cuda or cpu, not {feat.device}")
    with torch.cuda.device(feat.device):  # the launch goes to the current device
        return _launch(feat, idx_n, idx_by, idx_bx, block, halo)
