"""Eval-mode ``compute_unknown``: CUDA kernel wrapper and its plain PyTorch twin.

Port of the TPU kernel ``maggie_tpu/ops/pallas/unknown.py::compute_unknown_pallas``
(kernel source ``csrc/compute_unknown.cu``): threshold float alpha maps to
(1/255, 254/255), dilate with the cv2 ``MORPH_ELLIPSE`` element of width
``k_size // 2``, return a 0/1 map in the input dtype. Eval only: the
zero-gradient rule and the train-mode random width come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..morphology import LOWER_THRES, UPPER_THRES, _ellipse_row_runs, dilate_ellipse

# Incremented once per kernel launch (never by the plain twin).
launches = 0

# The thresholds rounded to f32, as JAX compares a float32 array with a Python
# float; the twin and the kernel both compare with these exact values.
_LO = float(np.float32(LOWER_THRES))
_HI = float(np.float32(UPPER_THRES))


def compute_unknown_plain(masks: torch.Tensor, k_size: int = 30) -> torch.Tensor:
    """Plain PyTorch twin (the JAX package's XLA path, ``morphology.py:195-197``)."""
    uncertain = ((masks > _LO) & (masks < _HI)).float()
    return dilate_ellipse(uncertain, k_size // 2).to(masks.dtype)


_fn = None  # the C entry point, set up at first launch


def _entry():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("compute_unknown").compute_unknown_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _sorted_runs(width: int) -> list[tuple[int, int, int]]:
    """Row runs ordered so that their extents nest, as the kernel's widening
    horizontal OR requires; raises if they do not."""
    runs = list(_ellipse_row_runs(width)) if width > 1 else [(0, 0, 0)]
    runs.sort(key=lambda r: (r[2] - r[1], r[0]))
    for (_, a0, b0), (_, a1, b1) in zip(runs, runs[1:]):
        if not (a1 <= a0 and b1 >= b0):
            raise ValueError(f"ellipse row runs of width {width} do not nest: {runs}")
    return runs


@functools.lru_cache(maxsize=16)
def _run_table(k_size: int):
    """The kernel's run arguments for ``k_size``: (dy, a, b) as C int arrays,
    the run count and the row and column halos."""
    runs = _sorted_runs(k_size // 2)
    arr = ctypes.c_int * len(runs)
    ry = max(abs(r[0]) for r in runs)
    rx = max(max(-r[1], r[2]) for r in runs)
    return (arr(*(r[0] for r in runs)), arr(*(r[1] for r in runs)),
            arr(*(r[2] for r in runs)), len(runs), ry, rx)


def _launch(masks: torch.Tensor, k_size: int) -> torch.Tensor:
    global launches
    if masks.dtype != torch.float32:
        raise TypeError(f"compute_unknown kernel takes float32 alphas, not {masks.dtype}")
    if masks.dim() < 2 or not masks.is_contiguous():
        raise ValueError(f"compute_unknown kernel needs contiguous (..., H, W) maps, got "
                         f"shape {tuple(masks.shape)} strides {masks.stride()}")
    dy, ra, rb, n_runs, ry, rx = _run_table(k_size)
    h, w = masks.shape[-2:]
    m = masks.numel() // (h * w) if h * w else 0
    out = torch.empty_like(masks)
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    rc = _entry()(masks.data_ptr(), out.data_ptr(), m, h, w, _LO, _HI,
                  dy, ra, rb, n_runs, ry, rx, stream)
    if rc != 0:
        raise RuntimeError(f"compute_unknown kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def compute_unknown(masks: torch.Tensor, k_size: int = 30) -> torch.Tensor:
    """Eval-mode uncertainty region of float alpha maps (..., H, W): threshold to
    (1/255, 254/255), then elliptical dilation of width ``k_size // 2``; a 0/1
    map in the input dtype (reference ``maggie/utils/utils.py:28-55``). The CUDA
    kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if masks.device.type == "cpu":
        return compute_unknown_plain(masks, k_size)
    if masks.device.type != "cuda":
        raise ValueError(f"compute_unknown runs on cuda or cpu, not {masks.device}")
    with torch.cuda.device(masks.device):  # the launch goes to the current device
        return _launch(masks, k_size)
