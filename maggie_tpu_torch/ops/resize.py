"""Torch-parity resize ops (port of ``maggie_tpu/ops/resize.py``).

Bilinear resizes are written as two products with the same precomputed
interpolation matrices the JAX package uses (float64 source indices, f32
weights). That keeps the port's alphas within float rounding of the
reference's, which matters because ``compute_unknown`` thresholds them.
``resize_bilinear_np`` is the same resize in numpy, for the eval's host side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def _linear_weight_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic linear interpolation matrix (torch semantics)."""
    if out_size == in_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = dst * scale
    else:
        scale = in_size / out_size
        src = (dst + 0.5) * scale - 0.5
        src = np.maximum(src, 0.0)  # torch clamps the source index at 0
    x0 = np.floor(src).astype(np.int64)
    x0 = np.minimum(x0, in_size - 1)
    x1 = np.minimum(x0 + 1, in_size - 1)
    lam = (src - x0).astype(np.float32)
    w = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0), 1.0 - lam)
    np.add.at(w, (rows, x1), lam)
    return w


@functools.lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Torch legacy 'nearest' index map: src = floor(dst * in/out)."""
    dst = np.arange(out_size, dtype=np.float64)
    idx = np.floor(dst * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def _weights(in_size: int, out_size: int, align_corners: bool, device) -> torch.Tensor:
    return torch.from_numpy(_linear_weight_matrix(in_size, out_size, align_corners)).to(device)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of the last two dims, matching ``F.interpolate(mode='bilinear')``."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    wh = _weights(h_in, h_out, align_corners, x.device)
    ww = _weights(w_in, w_out, align_corners, x.device)
    y = x.reshape(-1, h_in, w_in).float()
    y = torch.matmul(torch.matmul(wh, y), ww.t())
    return y.reshape(x.shape[:-2] + (h_out, w_out)).to(x.dtype)


def resize_bilinear_nhwc(x: torch.Tensor, size: tuple[int, int],
                         align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize for NHWC feature tensors (spatial dims 1 and 2)."""
    y = resize_bilinear(x.permute(0, 3, 1, 2), size, align_corners)
    return y.permute(0, 2, 3, 1)


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int],
                       align_corners: bool = False) -> np.ndarray:
    """Host (numpy) twin of :func:`resize_bilinear` with the same matrices and
    the JAX package's f32 einsums (``maggie_tpu/ops/resize.py:73``), so eval's
    ``reverse_transform`` gives its numbers bit for bit."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    dtype = x.dtype
    wh = _linear_weight_matrix(h_in, h_out, align_corners)
    ww = _linear_weight_matrix(w_in, w_out, align_corners)
    lead = x.shape[:-2]
    y = x.reshape((-1, h_in, w_in)).astype(np.float32)
    y = np.einsum("oh,bhw->bow", wh, y)
    y = np.einsum("bow,pw->bop", y, ww)
    return y.reshape(lead + (h_out, w_out)).astype(dtype)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of the last two dims, matching torch legacy ``mode='nearest'``
    (floor index, ``maggie_tpu/ops/resize.py:49-53``)."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    hi = torch.from_numpy(_nearest_index(h_in, h_out)).to(x.device)
    wi = torch.from_numpy(_nearest_index(w_in, w_out)).to(x.device)
    return x.index_select(-2, hi).index_select(-1, wi)


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int | None = None) -> torch.Tensor:
    """Average pool over the last two dims (VALID padding), computed in f32."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape((-1, 1) + x.shape[-2:]).float(), kernel, stride or kernel)
    return y.reshape(lead + y.shape[-2:]).to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int | None = None) -> torch.Tensor:
    """Max pool over the last two dims (VALID padding)."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), kernel, stride or kernel)
    return y.reshape(lead + y.shape[-2:])


def resize_any_shape(x: torch.Tensor, scale_factor: float | None = None,
                     size: tuple[int, int] | None = None, mode: str = "bilinear",
                     align_corners: bool = False, use_max_pool: bool = False,
                     use_avg_pool_binary: bool = False) -> torch.Tensor:
    """Rank-agnostic resize over the last two dims (``maggie_tpu/ops/resize.py:136-168``;
    reference ``resizeAnyShape``, ``maggie/utils/utils.py:7-25``): ``use_max_pool``
    is a binary-preserving downsample by a max pool of stride round(1/scale),
    ``use_avg_pool_binary`` an average pool thresholded at 0; otherwise a
    bilinear (computed in f32) or nearest resize to ``size`` or the scaled size."""
    if use_max_pool or use_avg_pool_binary:
        if scale_factor is None or scale_factor >= 1.0:
            raise ValueError(f"pooled resizes downsample: scale_factor < 1, got {scale_factor}")
        stride = int(round(1.0 / scale_factor))
        if use_max_pool:
            return max_pool2d(x.float(), stride).to(x.dtype)
        return (avg_pool2d(x.float(), stride) > 0.0).to(x.dtype)
    if size is None:
        if scale_factor is None:
            raise ValueError("resize_any_shape needs scale_factor or size")
        size = (int(x.shape[-2] * scale_factor), int(x.shape[-1] * scale_factor))
    if mode == "bilinear":
        return resize_bilinear(x.float(), size, align_corners).to(x.dtype)
    if mode == "nearest":
        return resize_nearest(x, size)
    raise ValueError(f"Unsupported mode {mode}")
