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
from typing import NamedTuple

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

# The kernel's limits and work plan (csrc/compute_unknown.cu): halos up to 16,
# so element widths up to 33; 128-column strips; bands of at most 128 rows,
# staged in chunks of 32 or 40 rows.
MAX_WIDTH = 33
MAX_K_SIZE = 2 * MAX_WIDTH + 1
STRIP_COLS = 128
CHUNK_ROWS = (32, 40)
MAX_BAND_ROWS = 128
MIN_BAND_ROWS = 8
BLOCKS_PER_SM = 2


def _entry():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("compute_unknown").compute_unknown_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _sorted_runs(width: int) -> list[tuple[int, int, int]]:
    """Row runs ordered so that their extents nest (each contains the previous);
    raises if they do not."""
    runs = list(_ellipse_row_runs(width)) if width > 1 else [(0, 0, 0)]
    runs.sort(key=lambda r: (r[2] - r[1], r[0]))
    for (_, a0, b0), (_, a1, b1) in zip(runs, runs[1:]):
        if not (a1 <= a0 and b1 >= b0):
            raise ValueError(f"ellipse row runs of width {width} do not nest: {runs}")
    return runs


@functools.lru_cache(maxsize=16)
def run_table(k_size: int) -> tuple[tuple[tuple[int, int], ...], tuple[tuple[int, int], ...], int]:
    """The element of ``k_size`` as the kernel walks it (the kernel computes
    the same table at compile time, one instance per width): its distinct run
    extents (a, b), each containing the previous and column 0; its row runs as
    (dy, extent index); and the row halo ry. ValueError beyond the kernel's
    widths."""
    width = k_size // 2
    if width > MAX_WIDTH:
        raise ValueError(f"compute_unknown kernel takes k_size up to {MAX_K_SIZE} (element "
                         f"width {MAX_WIDTH}), got {k_size}")
    runs = _sorted_runs(width)
    extents = list(dict.fromkeys((a, b) for _, a, b in runs))
    if not all(a <= 0 <= b for a, b in extents):
        raise ValueError(f"ellipse row runs of width {width} miss the centre column: {runs}")
    return (tuple(extents), tuple((dy, extents.index((a, b))) for dy, a, b in runs),
            max(abs(dy) for dy, _, _ in runs))


class Plan(NamedTuple):
    extents: tuple[tuple[int, int], ...]
    runs: tuple[tuple[int, int], ...]
    ry: int
    band_rows: int       # output rows per thread block
    n_bands: int
    chunk_rows: int      # staged rows per load chunk
    n_strips: int        # 128-column strips per map
    vec: bool            # the 16-byte instance, else the element instance


def plan(m: int, h: int, w: int, k_size: int, sms: int, in_addr: int = 0,
         out_addr: int = 0) -> Plan:
    """The host's half of the kernel: run table, band height (a whole number
    of blocks per SM where the map allows), the chunk height that pads the
    band's staged rows least (ties to the smaller), and the instance, from the
    shape, the card's SM count and the two start addresses."""
    extents, runs, ry = run_table(k_size)
    n_strips = -(-w // STRIP_COLS)
    if m > 65535 or n_strips > 65535:
        raise ValueError(f"compute_unknown kernel takes up to 65535 maps and "
                         f"{65535 * STRIP_COLS} columns, got {m} maps of width {w}")
    n_bands = max(-(-BLOCKS_PER_SM * sms // (m * n_strips)), 1)
    band_rows = min(max(-(-h // n_bands), MIN_BAND_ROWS), MAX_BAND_ROWS)
    staged = band_rows + 2 * ry
    chunk_rows = min(CHUNK_ROWS, key=lambda c: (-(-staged // c) * c, c))
    vec = in_addr % 16 == 0 and out_addr % 16 == 0 and w % 4 == 0
    return Plan(extents, runs, ry, band_rows, -(-h // band_rows), chunk_rows, n_strips, vec)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(masks: torch.Tensor, k_size: int) -> torch.Tensor:
    global launches
    if masks.dtype != torch.float32:
        raise TypeError(f"compute_unknown kernel takes float32 alphas, not {masks.dtype}")
    if masks.dim() < 2 or not masks.is_contiguous():
        raise ValueError(f"compute_unknown kernel needs contiguous (..., H, W) maps, got "
                         f"shape {tuple(masks.shape)} strides {masks.stride()}")
    h, w = masks.shape[-2:]
    out = torch.empty_like(masks)
    if masks.numel() == 0:
        return out
    m = masks.numel() // (h * w)
    p = plan(m, h, w, k_size, _sm_count(masks.device.index), masks.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    rc = _entry()(masks.data_ptr(), out.data_ptr(), m, h, w, _LO, _HI, max(k_size // 2, 0),
                  p.band_rows, p.chunk_rows, int(p.vec), stream)
    if rc != 0:
        raise RuntimeError(f"compute_unknown kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def compute_unknown(masks: torch.Tensor, k_size: int = 30) -> torch.Tensor:
    """Eval-mode uncertainty region of float alpha maps (..., H, W): threshold to
    (1/255, 254/255), then elliptical dilation of width ``k_size // 2``; a 0/1
    map in the input dtype (reference ``maggie/utils/utils.py:28-55``). The CUDA
    kernel for a CUDA tensor, the plain twin for a CPU tensor.

    Alphas of another dtype (bf16) are widened to f32 first, for the twin as
    for the kernel, so that both compare with the f32 thresholds, as the TPU
    kernel does (``maggie_tpu/ops/pallas/unknown.py:100``)."""
    out_dtype = masks.dtype
    if masks.dtype != torch.float32:
        masks = masks.float()
    if masks.device.type == "cpu":
        return compute_unknown_plain(masks, k_size).to(out_dtype)
    if masks.device.type != "cuda":
        raise ValueError(f"compute_unknown runs on cuda or cpu, not {masks.device}")
    with torch.cuda.device(masks.device):  # the launch goes to the current device
        return _launch(masks, k_size).to(out_dtype)
