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
- ``structuring_element``, ``dilate`` and ``erode``: ``cv2.getStructuringElement``
  (``MORPH_RECT``, ``MORPH_ELLIPSE``, any size) and cv2's morphology of uint8
  maps by any 0/1 element, anchor ``(kw // 2, kh // 2)`` (off-centre for even
  sizes), pixels outside the map ignored. cv2 reads nothing outside a numpy
  view it is given (``tests/test_torch_mask_transforms.py`` shows it), and
  neither do these.
- ``find_contours_list``: ``cv2.findContours(img, RETR_LIST, CHAIN_APPROX_NONE)``,
  Suzuki-Abe border following as OpenCV runs it (``contours.cpp``): a 1-pixel
  zero frame, borders marked 2 or, where the border's right side is
  background, -126; outer borders start where a 0 is followed by a 1, holes
  where a marked-or-1 pixel (not -126) is followed by a 0; each border is
  traced from its start, every pixel written; the list is in reverse order
  of discovery, as cv2 inserts each new contour at the head of its list.
- ``contour_moments``: ``cv2.moments`` of a point contour (Green's theorem
  sums, exact in int64, then cv2's double scale factors): m00, m10, m01.
- ``fill_contours``: ``cv2.drawContours(zeros, contours, -1, value, -1)``: every
  contour's edges as one collection, each drawn as an 8-connected line, and
  filled by the scanline rule of ``FillEdgeCollection``: non-horizontal
  edges in 16-bit fixed point with a truncated slope, active on rows
  ``[y0, y1)``, sorted by x and paired, each pair filling from its left x
  rounded up to its right x rounded down. Overlaps and self-intersections
  go by the pairing (even-odd).
- ``gaussian_blur_u8``: ``cv2.GaussianBlur`` of uint8 images, cv2's bit-exact
  path (``smooth.dispatch.cpp``): the kernel in double, quantised to 8
  fractional bits with error diffusion and the centre taking the rest of
  256, applied separably in exact integers with ``BORDER_REFLECT_101``, the
  horizontal pass kept whole and the vertical one rounded at 16 bits.
- ``fill_ellipse``: ``cv2.ellipse(img, center, axes, 0, 0, 360, value, -1)``
  (``LINE_8``) on a float32 image, bit for bit (``drawing.cpp``): the
  outline from ``ellipse2Poly`` in 16-bit fixed point (the arc step 90, 30,
  18 or 5 degrees as the larger axis is under 3, 10, 15 pixels or more; cv2's
  float table of sines rounded to 7 decimals), each vertex rounded half to
  even and repeats dropped; then ``FillConvexPoly``: every edge drawn by the
  fixed-point ``Line2`` (clipped to the image by ``clipLine``), and the rows
  between the two edge chains walked from the top vertex, each row filled
  from its left x to its right x, both rounded at half a pixel and clipped.
- ``gaussian_blur_f32``: ``cv2.GaussianBlur(img, (k, k), 0)`` of a float32
  (H, W) image for k in 3, 5, 7, 9, bit for bit with OpenCV 5.0 on an AVX2
  host (``smooth.dispatch.cpp``, ``filter.simd.hpp``): with sigma 0 every
  one of these sizes takes cv2's fixed table (k = 9 too: 4, 13, 30, 51, 60
  over 256); ``BORDER_REFLECT_101``; the row pass, then the column pass, each
  in float32 in cv2's order of operations. Rows, k 3 and 5: the symmetric
  taps paired first, ``fma(c, k0, pair1 * k1)`` (k 3), then ``fma(pair2, k2,
  .)`` (k 5); k 7 and 9: a fused multiply-add chain over the taps from the
  first, on the 4-aligned columns; the columns after them in scalar code,
  the first ``4 * ((k - 1) // 4)`` products after tap 0 rounded and added,
  the rest fused (k 5: its odd last column ``c * k0 + pair1 * k1 + pair2 *
  k2``, each rounded). Columns: ``pair1 * k1 + c * k0`` fused (k 3); else
  ``c * k0``, then each pair fused in from the nearest, on the 8-aligned
  columns, and rounded and added on the columns after them.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from ..ops.morphology import ellipse_kernel, grey_dilate_runs, grey_erode_runs

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
    (x, y) inside ``img`` (``_line_pixels``)."""
    xs, ys = _line_pixels(*(np.array([v], np.int64) for v in (*p1, *p2)))
    img[ys, xs] = value
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
    """float32 fused multiply-add, rounded once: the product is exact in
    float64, the sum's rounding error is recovered (TwoSum), and where the
    float64 sum lands on a tie between two float32 values that error's sign
    breaks it."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    r = s.astype(np.float32)
    off = s - r.astype(np.float64)
    toward = np.nextafter(r, np.where(off > 0, np.float32(np.inf), np.float32(-np.inf)))
    tie = (off != 0) & (2 * off == toward.astype(np.float64) - r) & (err != 0)
    if tie.any():
        s = np.where(tie, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
        r = s.astype(np.float32)
    return r


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


MORPH_RECT, MORPH_ELLIPSE = 0, 2   # cv2's values


def structuring_element(shape: int, ksize: tuple[int, int]) -> np.ndarray:
    """``cv2.getStructuringElement(shape, ksize)``; ``ksize`` is cv2's (w, h)."""
    w, h = ksize
    if shape == MORPH_RECT:
        return np.ones((h, w), np.uint8)
    if shape == MORPH_ELLIPSE:
        return ellipse_kernel(w, h).copy()
    raise ValueError(f"structuring_element: shape {shape} is not MORPH_RECT or MORPH_ELLIPSE")


def _element_runs(kernel: np.ndarray) -> tuple[tuple[int, int, int], ...]:
    """The element's row runs (dy, a, b) about cv2's anchor (kw // 2, kh // 2)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    runs = []
    for i in range(kh):
        row = np.concatenate([[0], kernel[i] != 0, [0]]).astype(np.int8)
        edges = np.flatnonzero(np.diff(row))
        runs += [(i - ay, int(a) - ax, int(b) - 1 - ax) for a, b in zip(edges[::2], edges[1::2])]
    if not runs:
        raise ValueError("dilate/erode: the structuring element is empty")
    return tuple(runs)


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)`` of a uint8 map, a new array."""
    return grey_dilate_runs(img, _element_runs(kernel)).copy()


def erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.erode(img, kernel)`` of a uint8 map, a new array."""
    return grey_erode_runs(img, _element_runs(kernel)).copy()


# chain codes 0-7: east, then counter-clockwise as seen on the screen
_CHAIN_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CHAIN_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126   # cv2's mark: nbd 2 with the sign bit (schar)


def _follow_border(flat: np.ndarray, step: int, start: int, hole: bool) -> list[int]:
    """OpenCV's ``icvFetchContour`` with every point kept: the flat indices
    of the border of the framed int8 image ``flat`` that starts at ``start``,
    marking each pixel it leaves 2 or, where the search passed the
    background on its right, -126."""
    deltas = [_CHAIN_DX[s] + _CHAIN_DY[s] * step for s in range(8)] * 2
    s_end = s = 0 if hole else 4
    while True:   # clockwise from the background side for the first neighbour
        s = (s - 1) & 7
        i1 = start + deltas[s]
        if flat[i1] != 0 or s == s_end:
            break
    if s == s_end:   # a single pixel
        flat[start] = _RIGHT_BOUND
        return [start]
    points = []
    i3 = start
    while True:
        s_end = s
        while s < 15:   # counter-clockwise for the next border pixel
            s += 1
            i4 = i3 + deltas[s]
            if flat[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:
            flat[i3] = _RIGHT_BOUND
        elif flat[i3] == 1:
            flat[i3] = 2
        points.append(i3)
        if i4 == start and i3 == i1:
            return points
        i3 = i4
        s = (s + 4) & 7


def find_contours_list(img: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(img, RETR_LIST, CHAIN_APPROX_NONE)[0]`` of a 2-D map
    (nonzero is foreground): a list of int32 (n, 1, 2) point arrays (x, y).

    The raster scan runs over the candidate starts only, found with numpy:
    a pixel whose left neighbour is 0 where it is not, or the reverse. Each
    is checked in raster order against the marks the borders traced before
    it left, as cv2's scan reads them."""
    h, w = img.shape
    step = w + 2
    framed = np.zeros((h + 2, step), np.int8)
    framed[1:-1, 1:-1] = img != 0
    nz = framed != 0
    cand = np.zeros_like(nz)
    cand[:, 1:] = nz[:, 1:] != nz[:, :-1]
    flat = framed.ravel()
    found = []
    for i in np.flatnonzero(cand).tolist():
        p, prev = flat[i], flat[i - 1]
        if prev == 0 and p == 1:
            found.append(_follow_border(flat, step, i, hole=False))
        elif p == 0 and prev >= 1:
            found.append(_follow_border(flat, step, i - 1, hole=True))
    out = []
    for border in reversed(found):
        idx = np.asarray(border, np.int64)
        xy = np.stack([idx % step - 1, idx // step - 1], axis=1)
        out.append(xy.astype(np.int32).reshape(-1, 1, 2))
    return out


def contour_moments(points: np.ndarray) -> dict:
    """``m00``, ``m10`` and ``m01`` of ``cv2.moments(points)`` for an integer
    point contour (n, 1, 2) or (n, 2), equal to cv2's float64 values: the
    sums are whole numbers (exact in int64), scaled as cv2 scales them,
    and all 0 where the area is."""
    p = np.asarray(points, np.int64).reshape(-1, 2)
    if len(p) == 0:
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    x, y = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x, 1), np.roll(y, 1)   # the previous point, the last one first
    dxy = x1 * y - x * y1
    a00, a10, a01 = (float(v) for v in (dxy.sum(), (dxy * (x1 + x)).sum(), (dxy * (y1 + y)).sum()))
    if abs(a00) <= 1.1920928955078125e-07:   # FLT_EPSILON
        return {"m00": 0.0, "m10": 0.0, "m01": 0.0}
    half, sixth = (0.5, 0.16666666666666666666666666666667) if a00 > 0 else \
        (-0.5, -0.16666666666666666666666666666667)
    return {"m00": a00 * half, "m10": a10 * sixth, "m01": a01 * sixth}


def _line_pixels(x0, y0, x1, y1) -> tuple[np.ndarray, np.ndarray]:
    """The pixels of cv2's 8-connected line (OpenCV's ``LineIterator``) from
    (x0, y0) to (x1, y1) for every segment of the int64 arrays at once, one
    step of every walk per pass: left to right (the ends swapped when the
    second is left of the first) along the longer axis, stepping the other
    axis where the Bresenham error is negative, both ends drawn."""
    swap = x1 < x0
    x, y = np.where(swap, x1, x0), np.where(swap, y1, y0)
    dx, dy = np.abs(x1 - x0), np.where(swap, y0 - y1, y1 - y0)
    sy, dy = np.where(dy < 0, -1, 1), np.abs(dy)
    vert = dy > dx
    major, minor = np.where(vert, dy, dx), np.where(vert, dx, dy)
    err = major - 2 * minor
    xs, ys = [], []
    for t in range(int(major.max(initial=-1)) + 1):
        live = major >= t
        xs.append(x[live])
        ys.append(y[live])
        stepped = err < 0
        err = err - 2 * minor + np.where(stepped, 2 * major, 0)
        x = x + np.where(vert, stepped, 1)
        y = y + sy * np.where(vert, 1, stepped)
    return np.concatenate(xs or [x[:0]]), np.concatenate(ys or [y[:0]])


_XY_SHIFT = 16


def fill_contours(shape: tuple[int, int], contours, value: int = 255) -> np.ndarray:
    """``cv2.drawContours(np.zeros(shape, np.uint8), contours, -1, value,
    thickness=-1)``: the outlines and the even-odd fill of all contours
    together (see the module docstring)."""
    h, w = shape
    out = np.zeros(shape, np.uint8)
    polys = [np.asarray(c, np.int64).reshape(-1, 2) for c in contours]
    polys = [p for p in polys if len(p)]
    if not polys:
        return out
    p1 = np.concatenate(polys)
    p0 = np.concatenate([np.roll(p, 1, axis=0) for p in polys])   # each edge from the point before
    lx, ly = _line_pixels(p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1])
    inside = (lx >= 0) & (lx < w) & (ly >= 0) & (ly < h)
    out[ly[inside], lx[inside]] = value
    edge = p0[:, 1] != p1[:, 1]
    if edge.sum() < 2:
        return out
    p0, p1 = p0[edge], p1[edge]
    num = (p1[:, 0] - p0[:, 0]) << _XY_SHIFT
    den = p1[:, 1] - p0[:, 1]
    slope = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))   # C's truncation
    top = np.where((p0[:, 1] < p1[:, 1])[:, None], p0, p1)
    y0, y1 = top[:, 1], np.maximum(p0[:, 1], p1[:, 1])
    x0 = top[:, 0] << _XY_SHIFT
    rows = y1 - y0
    e = np.repeat(np.arange(len(rows)), rows)
    k = np.arange(int(rows.sum())) - np.repeat(np.cumsum(rows) - rows, rows)
    ys, xs = y0[e] + k, x0[e] + k * slope[e]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # every row crosses each closed contour an even number of times, so the
    # sorted crossings pair up within their rows
    ya = ys[0::2]
    xa = (xs[0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    xb = xs[1::2] >> _XY_SHIFT
    keep = (ya >= 0) & (ya < h) & (xa < w) & (xb >= 0) & (xa <= xb)
    ya, xa, xb = ya[keep], np.maximum(xa[keep], 0), np.minimum(xb[keep], w - 1)
    spans = np.zeros((h, w + 1), np.int32)
    np.add.at(spans, (ya, xa), 1)
    np.add.at(spans, (ya, xb + 1), -1)
    out[np.cumsum(spans, axis=1)[:, :w] > 0] = value
    return out


@functools.lru_cache(maxsize=64)
def gaussian_kernel_u8(n: int, sigma: float) -> tuple[int, ...]:
    """cv2's 8-bit Gaussian kernel of odd size ``n`` and ``sigma`` > 0: the
    double kernel of ``getGaussianKernelBitExact`` (``exp(x*x * -0.125 /
    sigma**2)`` over x = 1-n, 3-n, ..., normalised by its sum), times 256
    with error diffusion from the outer taps in (rounded half to even), the
    centre tap taking what is left of 256."""
    if n % 2 != 1 or sigma <= 0:
        raise ValueError(f"gaussian_kernel_u8: odd size and sigma > 0, not {n}, {sigma}")
    scale = -0.125 / (float(sigma) * float(sigma))
    half = (n - 1) // 2
    values = [math.exp(float(x * x) * scale) for x in range(1 - n, 0, 2)]
    total = 0.0
    for v in values:
        total += v
    mul = 1.0 / (total * 2.0 + 1.0)
    taps, err, whole = [0] * n, 0.0, 0
    for i, v in enumerate(values):
        adj = v * mul * 256.0 + err
        q = round(adj)
        err = adj - float(q)
        taps[i] = taps[n - 1 - i] = q
        whole += q
    taps[half] = 256 - 2 * whole
    return tuple(taps)


def gaussian_blur_u8(img: np.ndarray, k: int, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), sigma)`` of a uint8 (H, W) or (H, W, C)
    image, bit for bit (``BORDER_REFLECT_101``)."""
    if img.dtype != np.uint8:
        raise TypeError(f"gaussian_blur_u8 takes uint8 images, not {img.dtype}")
    taps = gaussian_kernel_u8(k, sigma)
    a = k // 2
    h, w = img.shape[:2]
    rest = [(0, 0)] * (img.ndim - 2)
    p = np.pad(img.astype(np.int64), [(0, 0), (a, a)] + rest, mode="reflect")
    rows = sum(t * p[:, i:i + w] for i, t in enumerate(taps))
    p = np.pad(rows, [(a, a), (0, 0)] + rest, mode="reflect")
    out = sum(t * p[i:i + h] for i, t in enumerate(taps))
    return np.clip((out + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


# cv2's sine table (``drawing.cpp``, ``SinTable``): sin of each whole degree
# 0-450 rounded to 7 decimals, as float32
_SIN_TABLE = np.float32(np.round(np.sin(np.radians(np.arange(451))), 7)).astype(np.float64)
_XY_ONE = 1 << _XY_SHIFT


def _ellipse_vertices(center: tuple[int, int], axes: tuple[int, int]) -> list[tuple[int, int]]:
    """``EllipseEx``'s polygon of a whole ellipse at angle 0, in 16-bit fixed
    point: ``ellipse2Poly``'s points rounded half to even, repeats dropped."""
    cx, cy = int(center[0]) << _XY_SHIFT, int(center[1]) << _XY_SHIFT
    aw, ah = abs(int(axes[0])) << _XY_SHIFT, abs(int(axes[1])) << _XY_SHIFT
    size = (max(aw, ah) + (_XY_ONE >> 1)) >> _XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    out: list[tuple[int, int]] = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x, y = float(aw) * _SIN_TABLE[450 - a], float(ah) * _SIN_TABLE[a]
        pt = []
        for v in (float(cx) + x, float(cy) + y):
            whole = int(np.rint(v / _XY_ONE)) << _XY_SHIFT
            pt.append(whole + int(np.rint(v - whole)))
        if not out or tuple(pt) != out[-1]:
            out.append(tuple(pt))
    return out if len(out) > 1 else [(cx, cy)] * 2


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """cv2's ``clipLine`` of a fixed-point segment to [0, w - 1] x [0, h - 1]:
    (inside, p1, p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line2(img: np.ndarray, p1, p2, value) -> None:
    """cv2's ``Line2``: the 8-connected line between two 16-bit fixed-point
    points, drawn in place."""
    h, w = img.shape
    inside, (x1, y1), (x2, y2) = _clip_line(w << _XY_SHIFT, h << _XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    half = _XY_ONE >> 1
    x_major = abs(dx) > abs(dy)
    if dx < 0 if x_major else dy < 0:     # walk left to right (top to bottom)
        (dx, dy), x1, x2, y1, y2 = (dx, -dy) if x_major else (-dx, dy), x2, x1, y2, y1
    if x_major:
        t = np.arange(((x2 - x1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = ((x1 + half) >> _XY_SHIFT) + t
        ys = (y1 + half + t * _c_div(dy << _XY_SHIFT, abs(dx) | 1)) >> _XY_SHIFT
    else:
        t = np.arange(((y2 - y1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = (x1 + half + t * _c_div(dx << _XY_SHIFT, abs(dy) | 1)) >> _XY_SHIFT
        ys = ((y1 + half) >> _XY_SHIFT) + t
    # the far end is drawn first, then the walk
    xs = np.append((x2 + half) >> _XY_SHIFT, xs)
    ys = np.append((y2 + half) >> _XY_SHIFT, ys)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = value


def _fill_convex_poly(img: np.ndarray, v: list[tuple[int, int]], value) -> None:
    """cv2's ``FillConvexPoly`` of 16-bit fixed-point vertices (``LINE_8``)."""
    h, w = img.shape
    n, half = len(v), _XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, value)
        p0 = p
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> _XY_SHIFT, (max(xs) + half) >> _XY_SHIFT
    ymin, ymax = (min(ys) + half) >> _XY_SHIFT, (max(ys) + half) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # the two edge chains from the top vertex: [index, step, x, dx, end row]
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    edges, y = n, ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            i0 = e[0]
            i = (i0 + e[1]) % n
            while edges > 0:
                edges -= 1
                ty = (v[i][1] + half) >> _XY_SHIFT
                if ty > y:
                    e[0], e[2], e[4] = i, v[i0][0], ty
                    e[3] = _c_div((v[i][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y))
                    break
                i0, i = i, (i + e[1]) % n
            else:
                edges -= 1
        if edges < 0:
            return
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x1, x2 = (left + half) >> _XY_SHIFT, (right + half) >> _XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = value
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            return


def fill_ellipse(img: np.ndarray, center: tuple[int, int], axes: tuple[int, int],
                 value: float) -> np.ndarray:
    """Draw ``cv2.ellipse(img, center, axes, 0, 0, 360, value, -1)`` in place
    on a float32 (H, W) image (see the module docstring)."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"fill_ellipse draws on float32 (H, W) images, not {img.dtype} "
                        f"{img.shape}")
    _fill_convex_poly(img, _ellipse_vertices(center, axes), np.float32(value))
    return img


# cv2's Gaussian kernels for sigma 0 (``getGaussianKernelBitExact``), the
# centre tap and those after it
_GAUSS_F32 = {3: (0.5, 0.25), 5: (0.375, 0.25, 0.0625),
              7: (0.28125, 0.21875, 0.109375, 0.03125),
              9: (60 / 256, 51 / 256, 30 / 256, 13 / 256, 4 / 256)}


def _mul32(a, b) -> np.ndarray:
    return np.multiply(a, np.float32(b), dtype=np.float32)


def _add32(a, b) -> np.ndarray:
    return np.add(a, b, dtype=np.float32)


def _blur_rows(p: np.ndarray, k: int, w: int) -> np.ndarray:
    """The row pass on ``p``, the image padded by ``k // 2`` columns."""
    taps, a = _GAUSS_F32[k], k // 2
    col = lambda o: p[:, a + o:a + o + w]
    if k == 3:
        return _fma32(col(0), taps[0], _mul32(_add32(col(-1), col(1)), taps[1]))
    if k == 5:
        pair1, pair2 = _add32(col(-1), col(1)), _add32(col(-2), col(2))
        out = _fma32(pair2, taps[2], _fma32(col(0), taps[0], _mul32(pair1, taps[1])))
        if (w % 8) % 2:      # the column after the vectors and the pairs
            out[:, -1] = _add32(_add32(_mul32(col(0)[:, -1], taps[0]),
                                       _mul32(pair1[:, -1], taps[1])),
                                _mul32(pair2[:, -1], taps[2]))
        return out
    full = taps[:0:-1] + taps
    fused_from = 4 * ((k - 1) // 4)
    v = w // 4 * 4

    def chain(lo: int, hi: int, scalar: bool) -> np.ndarray:
        s = _mul32(p[:, lo:hi], full[0])
        for i in range(1, k):
            x = p[:, lo + i:hi + i]
            s = (_add32(s, _mul32(x, full[i])) if scalar and i <= fused_from
                 else _fma32(x, full[i], s))
        return s
    return np.concatenate([chain(0, v, False), chain(v, w, True)], axis=1)


def _blur_cols(p: np.ndarray, k: int, h: int, w: int) -> np.ndarray:
    """The column pass on ``p``, the row pass padded by ``k // 2`` rows."""
    taps, a = _GAUSS_F32[k], k // 2
    row = lambda o: p[a + o:a + o + h]
    if k == 3:
        return _fma32(_add32(row(-1), row(1)), taps[1], _mul32(row(0), taps[0]))
    v = w // 8 * 8
    fused = _mul32(row(0)[:, :v], taps[0])
    rounded = _mul32(row(0)[:, v:], taps[0])
    for i in range(1, a + 1):
        pair = _add32(row(i), row(-i))
        fused = _fma32(pair[:, :v], taps[i], fused)
        rounded = _add32(rounded, _mul32(pair[:, v:], taps[i]))
    return np.concatenate([fused, rounded], axis=1)


def gaussian_blur_f32(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of a float32 (H, W) image, k in 3,
    5, 7, 9 (see the module docstring). As cv2, a single row or column is
    blurred along its length only."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"gaussian_blur_f32 takes float32 (H, W) images, not {img.dtype} "
                        f"{img.shape}")
    if k not in _GAUSS_F32:
        raise ValueError(f"gaussian_blur_f32 takes k in {sorted(_GAUSS_F32)}, not {k}")
    h, w = img.shape
    a = k // 2
    out = img
    if w > 1:
        out = _blur_rows(np.pad(out, [(0, 0), (a, a)], mode="reflect"), k, w)
    if h > 1:
        out = _blur_cols(np.pad(out, [(a, a), (0, 0)], mode="reflect"), k, h, w)
    return out.copy() if out is img else out
