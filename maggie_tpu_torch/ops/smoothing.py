"""``gaussian_smoothing`` (port of ``maggie_tpu/ops/smoothing.py``; reference
``maggie/utils/utils.py:61-83``), with the reference's quirks: the "2-D" kernel
is g(j)^2 on every row (the reference multiplies two identically shaped
(1, 1, k) views, ``:65``), and the result is over-cropped by the pad and
resized back bilinearly (``:81-82``).

The chain (zero pad, VALID conv with that kernel, over-crop, bilinear resize
back) is linear and separable, so it is one row matrix and one column matrix:
two ``torch.matmul`` products per map, with the matrices the JAX package
builds. Maps no larger than ``2 * pad`` keep the literal conv form.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .resize import _linear_weight_matrix, resize_bilinear


@functools.lru_cache(maxsize=16)
def _g2(sigma: int) -> np.ndarray:
    size = sigma * 2 + 1
    grid = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-grid ** 2 / (2 * sigma ** 2))
    g = g / g.sum()
    return (g * g).astype(np.float32)  # the reference's row-constant g(j)^2


@functools.lru_cache(maxsize=32)
def _smoothing_matrices(h: int, w: int, sigma: int) -> tuple[np.ndarray, np.ndarray]:
    """(L_rows (h, h), L_cols (w, w)) with smooth(x) == L_rows @ x @ L_cols^T."""
    size = sigma * 2 + 1
    pad = size // 2
    g2 = _g2(sigma).astype(np.float64)
    # VALID conv + crop: cropped row r = sum_i x[r + i], i in [0, size)
    cv = np.zeros((h - 2 * pad, h), dtype=np.float64)
    for i in range(size):
        cv[np.arange(h - 2 * pad), np.arange(h - 2 * pad) + i] += 1.0
    hc = np.zeros((w - 2 * pad, w), dtype=np.float64)
    for j in range(size):
        hc[np.arange(w - 2 * pad), np.arange(w - 2 * pad) + j] += g2[j]
    rr = _linear_weight_matrix(h - 2 * pad, h, False).astype(np.float64)
    rc = _linear_weight_matrix(w - 2 * pad, w, False).astype(np.float64)
    return (rr @ cv).astype(np.float32), (rc @ hc).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_matrices(h: int, w: int, sigma: int,
                     device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_smoothing_matrices`` on ``device`` (L_cols transposed), copied there
    once. Made outside inference mode, so a later call with autograd on can
    use them."""
    lr, lc = _smoothing_matrices(h, w, sigma)
    with torch.inference_mode(False):
        return torch.from_numpy(lr).to(device), torch.from_numpy(lc).to(device).t()


def gaussian_smoothing(x: torch.Tensor, sigma: int) -> torch.Tensor:
    """x: (N, C, H, W) maps; returns the same shape and dtype (f32 inside)."""
    pad = sigma
    n, c, h, w = x.shape
    if h <= 2 * pad or w <= 2 * pad:  # degenerate maps: keep the literal chain
        return _gaussian_smoothing_conv(x, sigma)
    lr, lc_t = _device_matrices(h, w, sigma, x.device)
    y = torch.matmul(torch.matmul(lr, x.reshape(n * c, h, w).float()), lc_t)
    return y.reshape(n, c, h, w).to(x.dtype)


def _gaussian_smoothing_conv(x: torch.Tensor, sigma: int) -> torch.Tensor:
    """Literal op-by-op form (pad, conv, crop, resize): reference semantics."""
    size = sigma * 2 + 1
    pad = size // 2
    n, c, h, w = x.shape
    k = torch.from_numpy(np.broadcast_to(_g2(sigma)[None, :], (size, size)).copy())
    y = F.conv2d(x.reshape(n * c, 1, h, w).float(), k.to(x.device)[None, None], padding=pad)
    if h <= 2 * pad or w <= 2 * pad:
        # maps too small for the reference's over-crop (it would crash on
        # these): the SAME-padded conv result
        return y.reshape(n, c, h, w).to(x.dtype)
    y = y[:, :, pad:-pad, pad:-pad].reshape(n, c, h - 2 * pad, w - 2 * pad)
    return resize_bilinear(y, (h, w), align_corners=False).to(x.dtype)
