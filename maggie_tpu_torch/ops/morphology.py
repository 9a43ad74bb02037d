"""Elliptical dilation and uncertainty-region extraction (eval mode).

Port of ``maggie_tpu/ops/morphology.py``. The cv2 ``MORPH_ELLIPSE`` structuring
element is reproduced bit-exactly (cv2's banker's rounding and even-width anchor
asymmetry included), and the dilation of a 0/1 map is the max over the
element's row runs of vertically shifted horizontal run-maxes.

``grey_dilate_ellipse`` and ``grey_erode_ellipse`` are cv2's dilation and
erosion of float maps, in numpy for the eval data pipeline's transition band.

Eval-mode ``compute_unknown`` (threshold, then this dilation) lives beside its
CUDA kernel in ``ops/kernels/unknown.py``. Train mode (a random width per map,
``dilate_ellipse_random``) comes with the training slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

LOWER_THRES = 1.0 / 255.0
UPPER_THRES = 254.0 / 255.0


@functools.lru_cache(maxsize=64)
def ellipse_kernel(width: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (width, width)) replica."""
    r = width // 2
    c = width // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    k = np.zeros((width, width), dtype=np.uint8)
    for i in range(width):
        dy = i - r
        if abs(dy) <= r:
            if r > 0:
                # cv2 uses saturate_cast<int> == round-half-to-even on the double
                dx = int(np.round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            else:
                dx = 0
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, width)
            k[i, j1:j2] = 1
    return k


@functools.lru_cache(maxsize=64)
def _ellipse_row_runs(width: int) -> tuple[tuple[int, int, int], ...]:
    """Decompose the SE into per-row horizontal runs: (dy, a, b) meaning the SE
    covers offsets (dy, dx) for dx in [a, b]. Exact for cv2's even-width anchors."""
    se = ellipse_kernel(width)
    anchor = width // 2
    runs = []
    for sy in range(width):
        cols = np.nonzero(se[sy])[0]
        if len(cols) == 0:
            continue
        runs.append((sy - anchor, int(cols[0] - anchor), int(cols[-1] - anchor)))
    return tuple(runs)


def _hmax_run(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """out[..., j] = max over x[..., j+a : j+b+1] (zero padded). x: (M, 1, H, W)."""
    n = b - a + 1
    if n == 1 and a == 0:
        return x
    return F.max_pool2d(F.pad(x, (-a, b)), (1, n), stride=1)


def _vshift(h: torch.Tensor, dy: int) -> torch.Tensor:
    """out[..., y, :] = h[..., y + dy, :], zero beyond the map."""
    if dy > 0:
        return F.pad(h[..., dy:, :], (0, 0, 0, dy))
    if dy < 0:
        return F.pad(h[..., :dy, :], (0, 0, -dy, 0))
    return h


def dilate_ellipse(binary: torch.Tensor, width: int) -> torch.Tensor:
    """Dilate 0/1 maps (..., H, W) with a cv2 MORPH_ELLIPSE element of ``width``.

    Exact match of ``cv2.dilate(x, Kernels[width])`` for 0/1 inputs: one 1D
    max-pool per distinct run extent, then a vertical shift-max. Zero padding is
    exact because cv2's out-of-border value never wins a max over a 0/1 map."""
    if width <= 1:
        return binary
    lead = binary.shape[:-2]
    H, W = binary.shape[-2:]
    x = binary.reshape(-1, 1, H, W).float()
    runs = _ellipse_row_runs(width)
    hmax: dict[tuple[int, int], torch.Tensor] = {}
    for _, a, b in runs:
        if (a, b) not in hmax:
            hmax[(a, b)] = _hmax_run(x, a, b)
    out = None
    for dy, a, b in runs:
        shifted = _vshift(hmax[(a, b)], dy)
        out = shifted if out is None else torch.maximum(out, shifted)
    return (out > 0.0).reshape(lead + (H, W)).to(binary.dtype)


def grey_dilate_ellipse(x: np.ndarray, width: int) -> np.ndarray:
    """``cv2.dilate(x, MORPH_ELLIPSE(width))`` of float32 maps (..., H, W), on
    the host: the max over the element of in-map pixels.

    Pixels outside the map are ignored, as cv2 ignores them, by padding with
    -inf: the zero padding of ``dilate_ellipse`` is exact only for maps that
    are 0 or above, and would break ``grey_erode_ellipse``, which dilates the
    negated map. Each row run's horizontal max comes from a doubling table
    (max over 1, 2, 4, ... columns; two lookups per run), then one vertical
    max per row of the element."""
    if width <= 1:
        return x
    runs = _ellipse_row_runs(width)
    H, W = x.shape[-2:]
    lead = x.shape[:-2]
    left, right = max(-a for _, a, _ in runs), max(b for _, _, b in runs)
    up, down = max(-dy for dy, _, _ in runs), max(dy for dy, _, _ in runs)
    table = [np.full(lead + (H, left + W + right), -np.inf, np.float32)]
    table[0][..., left:left + W] = x
    span = 1
    while 2 * span <= max(b - a + 1 for _, a, b in runs):
        t = table[-1]
        table.append(np.maximum(t[..., :-span], t[..., span:]))
        span *= 2
    out = np.full(lead + (H, W), -np.inf, np.float32)
    hrun = np.full(lead + (up + H + down, W), -np.inf, np.float32)
    for a, b in dict.fromkeys((a, b) for _, a, b in runs):
        k = (b - a + 1).bit_length() - 1
        lo, hi = left + a, left + b - (1 << k) + 1
        np.maximum(table[k][..., lo:lo + W], table[k][..., hi:hi + W],
                   out=hrun[..., up:up + H, :])
        for dy, a2, b2 in runs:
            if (a2, b2) == (a, b):
                np.maximum(out, hrun[..., up + dy:up + dy + H, :], out=out)
    return out


def grey_erode_ellipse(x: np.ndarray, width: int) -> np.ndarray:
    """``cv2.erode(x, MORPH_ELLIPSE(width))`` of float32 maps: the dual of
    ``grey_dilate_ellipse``, the min over the element of in-map pixels."""
    return -grey_dilate_ellipse(-x, width)
