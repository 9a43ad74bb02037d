"""The cv2 image operations of the data pipeline, in numpy (the port imports no cv2).

- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` of a uint8 image, bit for
  bit. cv2's fixed-point form (``imgproc/src/resize.cpp``, ``resizeGeneric_``
  with ``HResizeLinear`` and ``VResizeLinearVec_32s8u``): 11-bit coefficients,
  each rounded on its own from a float32 fraction; an exact integer horizontal
  pass; a vertical pass in 16-bit high-half products. Source columns are
  clamped with their fraction set to 0; source rows are clamped but keep their
  weights.
- ``resize_nearest``: ``INTER_NEAREST``, source index ``floor(j * (1 / (dst /
  src)))`` in float64, as cv2 computes its scale.
- ``pad_bottom_right`` and ``copy_make_border``: ``cv2.copyMakeBorder`` with a
  zero constant.
- ``warp_affine``: ``cv2.warpAffine`` with ``BORDER_CONSTANT`` 0, bilinear for
  uint8 (H, W, 3) frames and nearest for 2-D maps, bit for bit with OpenCV
  5.0's float path on an AVX2 host (``imgproc/src/warp_kernels.simd.hpp``):
  the forward map inverted in float64 and cast to float32; per row,
  ``y * M[1] + M[2]`` rounded in float32; the source column of each output
  in a vector of 16 as ``fma(M[0], x, row)``, and in the scalar tail after the
  last full vector as ``fma(x, M[0], y * M[1]) + M[2]`` (likewise for rows);
  bilinear weights from the fractional parts, blended as
  ``fma(a, p01 - p00, p00)`` in float32 and rounded half to even; nearest
  rounds the source coordinate half to even. A fused multiply-add of float32
  values is exact here in float64 (every sum holds in 53 bits at these
  magnitudes), then rounded once to float32. Other builds of cv2 warp
  otherwise: OpenCV 4 works in fixed point, and a host without AVX2 runs
  another vector width; against them the replica is not bit-equal.
- ``dilate_rect`` and ``erode_rect``: ``cv2.dilate``/``cv2.erode`` of uint8 maps
  with a ``k x k`` rectangle, anchor ``k // 2``, pixels outside ignored.
- ``jpeg_roundtrip``: ``cv2.imencode('.jpg', ...)`` then ``cv2.imdecode`` of an
  RGB frame, through PIL's encoder with its default 4:2:0 subsampling (the
  same bytes' decode, bit for bit, as libjpeg is behind both).
- ``line``: ``cv2.line(img, p1, p2, value, thickness=1)``, the 8-connected
  Bresenham walk of OpenCV's ``LineIterator`` from left to right, both ends
  drawn, bit for bit.
- ``filter2d``: ``cv2.filter2D(img.astype(np.float32), -1, kern)`` (correlation,
  anchor at the kernel's centre, ``BORDER_REFLECT_101``) computed exactly and
  rounded once to float32. cv2 sums in float32, and through a DFT for kernels
  of 11x11 and up, so its result differs in the last bits; after MotionBlur's
  clip and truncation to uint8 that moves a pixel by at most one level
  (``tests/test_torch_video_train_data.py`` states the share).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ops.morphology import grey_dilate_runs, grey_erode_runs

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
    # channels folded into the columns: (H, W*C), each output column's taps
    # are its channel's, so every row is one contiguous gather
    c = img.shape[2] if img.ndim == 3 else 1
    ch = np.arange(c)
    xi0, xi1 = (x0[:, None] * c + ch).ravel(), (x1[:, None] * c + ch).ravel()
    wa0, wa1 = np.repeat(a0, c).astype(np.int32), np.repeat(a1, c).astype(np.int32)
    p = img.reshape(h, w * c).astype(np.int32)
    # horizontal: exact 32-bit products (at most 255 * 2048)
    r = p[:, xi0] * wa0 + p[:, xi1] * wa1
    r0, r1 = r[y0] >> 4, r[y1] >> 4
    b0, b1 = b0.astype(np.int32)[:, None], b1.astype(np.int32)[:, None]
    out = (((b0 * r0) >> 16) + ((b1 * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((dh, dw) + img.shape[2:])


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
    return copy_make_border(img, 0, ph, 0, pw)


def copy_make_border(img: np.ndarray, top: int, bottom: int, left: int, right: int) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right, BORDER_CONSTANT, value=0)``."""
    return np.pad(img, ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2))


def line(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int], value) -> np.ndarray:
    """Draw ``cv2.line(img, p1, p2, value, thickness=1)`` in place: points are
    (x, y) inside ``img``; the walk goes left to right (the ends swapped when
    ``p2`` is left of ``p1``) along the longer axis, stepping the other axis
    where the Bresenham error is negative."""
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:
        x, y, dx, dy = x2, y2, -dx, -dy
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    for _ in range(dx + 1):
        img[y, x] = value
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += int(step)
        else:
            x += 1
            y += sy * int(step)
    return img


def filter2d(images: np.ndarray, kern: np.ndarray) -> np.ndarray:
    """``cv2.filter2D(image.astype(np.float32), -1, kern)`` of each image of a
    stack (N, H, W) or (N, H, W, C), exactly: each distinct kernel value
    times the sum of the reflect-101 padded stack's slices at its taps, the
    sums exact (in int64 for integer images, float64 otherwise), rounded once
    to float32. Returns float32 of the stack's shape."""
    kh, kw = kern.shape
    ay, ax = kh // 2, kw // 2
    h, w = images.shape[1:3]
    pad = [(0, 0), (ay, kh - 1 - ay), (ax, kw - 1 - ax)] + [(0, 0)] * (images.ndim - 3)
    acc = np.int64 if np.issubdtype(images.dtype, np.integer) else np.float64
    padded = np.pad(images.astype(acc), pad, mode="reflect")
    out = np.zeros(images.shape, np.float64)
    for value in np.unique(kern[kern != 0]):
        total = np.zeros(images.shape, acc)
        for i, j in zip(*np.nonzero(kern == value)):
            total += padded[:, i:i + h, j:j + w]
        out += np.float64(value) * total
    return out.astype(np.float32)


_WARP_VECTOR = 16   # float32 lanes x 2 per vector step of the AVX2 kernel


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inversion of a 2x3 forward map (``imgwarp.cpp::warpAffine``), in
    float64, cast to float32 as the warp kernels take it."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, np.float32)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add: the exact float64 result rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _warp_sources(m: np.ndarray, h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """float32 source coordinates (sx, sy), each (h, w), of every output pixel."""
    inv = _invert_affine(m)
    x = np.arange(w, dtype=np.float32)[None, :]
    y = np.arange(h, dtype=np.float32)[:, None]
    t0 = w - w % _WARP_VECTOR
    out = []
    for a, b, c in ((inv[0], inv[1], inv[2]), (inv[3], inv[4], inv[5])):
        s = np.empty((h, w), np.float32)
        s[:, :t0] = _fma32(a, x[:, :t0], y * b + c)
        s[:, t0:] = _fma32(x[:, t0:], a, y * b) + c
        out.append(s)
    return out[0], out[1]


def _taps(img: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """img[yy, xx] as float32, 0 where (yy, xx) lies outside the map."""
    h, w = img.shape[:2]
    inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    v = img[np.where(inside, yy, 0), np.where(inside, xx, 0)].astype(np.float32)
    v[~inside] = 0
    return v


def warp_affine(img: np.ndarray, m: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, flags=INTER_LINEAR)`` of a uint8 (H, W, 3)
    frame, or ``flags=INTER_NEAREST`` of a 2-D map, zero outside; ``dsize`` is
    cv2's (w, h) and must be the source's size, as at the pipeline's calls."""
    if tuple(dsize) != (img.shape[1], img.shape[0]):
        raise ValueError(f"warp_affine keeps the size: dsize {dsize} for {img.shape[:2]}")
    h, w = img.shape[:2]
    sx, sy = _warp_sources(m, h, w)
    if img.ndim == 2:
        ix, iy = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = img[np.where(inside, iy, 0), np.where(inside, ix, 0)]
        out[~inside] = 0
        return out
    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError(f"warp_affine's bilinear path takes uint8 (H, W, C), not "
                        f"{img.dtype} {img.shape}")
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    a = (sx - ix.astype(np.float32))[..., None]
    b = (sy - iy.astype(np.float32))[..., None]
    p00, p01 = _taps(img, iy, ix), _taps(img, iy, ix + 1)
    p10, p11 = _taps(img, iy + 1, ix), _taps(img, iy + 1, ix + 1)
    top = _fma32(a, p01 - p00, p00)
    bottom = _fma32(a, p11 - p10, p10)
    return np.clip(np.rint(_fma32(b, bottom - top, top)), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _rect_runs(k: int) -> tuple[tuple[int, int, int], ...]:
    a = k // 2
    return tuple((dy - a, -a, k - 1 - a) for dy in range(k))


def dilate_rect(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k), np.uint8))`` of a uint8 map."""
    return grey_dilate_runs(img, _rect_runs(k))


def erode_rect(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k), np.uint8))`` of a uint8 map."""
    return grey_erode_runs(img, _rect_runs(k))


def jpeg_roundtrip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """An RGB uint8 frame encoded as JPEG at ``quality`` and decoded again."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=int(quality))
    buf.seek(0)
    with Image.open(buf) as im:
        return np.array(im.convert("RGB"))
