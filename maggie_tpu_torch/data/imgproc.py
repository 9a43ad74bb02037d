"""The cv2 image operations of the eval chain, in numpy (the port imports no cv2).

- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` of a uint8 image, bit for
  bit. cv2's fixed-point form (``imgproc/src/resize.cpp``, ``resizeGeneric_``
  with ``HResizeLinear`` and ``VResizeLinearVec_32s8u``): 11-bit coefficients,
  each rounded on its own from a float32 fraction; an exact integer horizontal
  pass; a vertical pass in 16-bit high-half products. Source columns are
  clamped with their fraction set to 0; source rows are clamped but keep their
  weights.
- ``resize_nearest``: ``INTER_NEAREST``, source index ``floor(j * (1 / (dst /
  src)))`` in float64, as cv2 computes its scale.
- ``pad_bottom_right``: ``cv2.copyMakeBorder`` with a zero constant.
"""

from __future__ import annotations

import functools

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = np.float32(1 << _COEF_BITS)


@functools.lru_cache(maxsize=256)
def _linear_taps(src: int, dst: int, scale: float, clamp_weights: bool):
    """(i0, i1, c0, c1): the two source indices and 11-bit weights per output."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_weights:  # horizontal: an index past either edge reads the edge alone
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.where(s < 0, 0, np.where(s >= src - 1, src - 1, s))
    c1 = np.rint(f * _COEF_SCALE).astype(np.int64)
    c0 = np.rint((np.float32(1) - f) * _COEF_SCALE).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), c0, c1


def _scale(src: int, dst: int) -> float:
    return 1.0 / (dst / src)   # cv2: inv_scale = dst / src, scale = 1 / inv_scale


def resize_linear(img: np.ndarray, size: tuple[int, int],
                  scale: tuple[float, float] | None = None) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> (h, w[, C]); ``size`` is cv2's (w, h).

    ``scale`` is cv2's (1/fx, 1/fy) when the caller gave fx/fy instead of a
    size (``cv2.resize(img, (0, 0), fx=fx, fy=fy)``)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    dw, dh = size
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize_linear: empty output size {size} for a {w}x{h} image")
    sx, sy = scale if scale is not None else (_scale(w, dw), _scale(h, dh))
    x0, x1, a0, a1 = _linear_taps(w, dw, sx, True)
    y0, y1, b0, b1 = _linear_taps(h, dh, sy, False)
    tail = (1,) * (img.ndim - 2)
    p = img.astype(np.int32)
    # horizontal: exact 32-bit products (at most 255 * 2048)
    r = p[:, x0] * a0.reshape((-1,) + tail).astype(np.int32) \
        + p[:, x1] * a1.reshape((-1,) + tail).astype(np.int32)
    r0, r1 = r[y0] >> 4, r[y1] >> 4
    bshape = (-1, 1) + tail
    out = (((b0.reshape(bshape) * r0) >> 16) + ((b1.reshape(bshape) * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_scale(img: np.ndarray, f: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=f, fy=f, interpolation=INTER_LINEAR)``."""
    h, w = img.shape[:2]
    size = (int(np.rint(w * f)), int(np.rint(h * f)))
    return resize_linear(img, size, scale=(1.0 / f, 1.0 / f))


@functools.lru_cache(maxsize=256)
def nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2 ``INTER_NEAREST``'s source index for each of ``dst`` outputs."""
    idx = np.floor(np.arange(dst, dtype=np.float64) * _scale(src, dst))
    return np.minimum(idx, src - 1).astype(np.int64)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_NEAREST)``; ``size`` is (w, h)."""
    h, w = img.shape[:2]
    dw, dh = size
    return img[nearest_index(h, dh)][:, nearest_index(w, dw)]


def pad_bottom_right(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """``cv2.copyMakeBorder(img, 0, ph, 0, pw, BORDER_CONSTANT, value=0)``."""
    return np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2))
