"""Dense optical flow after Farneback in numpy (float32 where OpenCV
computes in float, float64 where it does in double): the ``MESSDdt``
metric's flow and the demo's flow propagator.

``farneback_flow`` replicates ``cv2.calcOpticalFlowFarneback(prev, next,
None, pyr_scale, levels, winsize, iterations, poly_n, poly_sigma, flags)``
(OpenCV ``video/src/optflowgf.cpp``). Its defaults are the metric's setting,
``0.5, 5, 10, 2, 7, 1.5, cv2.OPTFLOW_FARNEBACK_GAUSSIAN``
(``maggie_tpu/utils/metrics.py:236-240``); the demo's ``FlowPropagator``
passes ``0.5, 4, 21, 5, 5, 1.1, 0`` (``demo/segmenters.py:155-160``):

- the pyramid: as many levels as keep both sides at 32 px or more (at most
  ``levels``). For each level, both frames are blurred at full size by a
  Gaussian of sigma (1/scale - 1) / 2 (3x3 [1/4, 1/2, 1/4] at scale 1),
  resized to the level's size bilinearly (an exact halving averages 2x2
  blocks, as cv2's resize does), and expanded; the flow starts at zero on
  the coarsest level and each finer level starts from the coarser flow
  resized and divided by ``pyr_scale``;
- the polynomial expansion (``FarnebackPolyExp``): a separable Gaussian-
  weighted least-squares fit of 1, x, y, x^2, y^2, xy over a
  (2 poly_n + 1)^2 neighbourhood (sigma ``poly_sigma``, replicated borders),
  vertical sums in float, horizontal ones in double, times the inverse of
  the fit's Gram matrix;
- the matrix update (``FarnebackUpdateMatrices``): the next frame's
  coefficients sampled bilinearly at the displaced position and averaged with
  the first frame's, the residual of the displacement, the products that
  make the 2x2 system and its right side, damped near the image border;
- the flow solve, ``iterations`` times, the matrices updated after each but
  the last: with ``OPTFLOW_FARNEBACK_GAUSSIAN``
  (``FarnebackUpdateFlow_GaussianBlur``) the five maps blurred by a
  winsize x winsize Gaussian (sigma 0.3 winsize/2), with ``flags`` 0
  (``FarnebackUpdateFlow_Blur``) by a winsize x winsize box as cv2's running
  sums compute it (rows in double from float differences, then columns in
  double), then the 2x2 system solved per pixel in double.

cv2 filters and resizes with vector code and, for the larger blurs, Intel
IPP, which round some sums otherwise: the replica's flows differ from cv2's
by float rounding, and ``tests/test_torch_flow.py`` holds it to cv2.
"""

from __future__ import annotations

import functools

import numpy as np

f32 = np.float32

OPTFLOW_FARNEBACK_GAUSSIAN = 256   # cv2's flag value
_MIN_SIZE = 32                 # cv2 stops the pyramid before a side gets shorter
_BORDER = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], f32)


# ---------------------------------------------------------------- filters
def _reflect101(n: int, pad: int) -> np.ndarray:
    """Source index of each of the n + 2*pad positions, cv2's BORDER_REFLECT_101."""
    period = 2 * n - 2
    idx = np.abs(np.arange(-pad, n + pad)) % period
    return np.where(idx >= n, period - idx, idx)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F): at scale 1 (sigma 0, 3
    taps) cv2's fixed table, else exp(-d^2 / (2 sigma^2)) normalised in
    double with the centre set to make the sum exactly one."""
    if sigma <= 0:
        return np.array([0.25, 0.5, 0.25], f32)
    half = ksize // 2
    d = np.arange(half, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp(-d * d / (2 * sigma * sigma))
    t = t / (2 * t.sum() + 1.0)
    return np.concatenate([t, [1.0 - 2 * t.sum()], t[::-1]]).astype(f32)


def _gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur of a float32 map, BORDER_REFLECT_101: a row pass, then
    a column pass that adds symmetric pairs."""
    k = _gaussian_kernel(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    src = img[:, _reflect101(w, r)]
    if ksize <= 5:  # cv2's small symmetric row filter: centre, then pairs
        row = src[:, r:r + w] * k[r]
        for i in range(1, r + 1):
            row = row + (src[:, r - i:r - i + w] + src[:, r + i:r + i + w]) * k[r + i]
    else:           # the general row filter: taps left to right
        row = src[:, 0:w] * k[0]
        for i in range(1, ksize):
            row = row + src[:, i:i + w] * k[i]
    col = row[_reflect101(h, r)]
    out = col[r:r + h] * k[r]
    for i in range(1, r + 1):
        out = out + (col[r - i:r - i + h] + col[r + i:r + i + h]) * k[r + i]
    return out


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2.resize INTER_LINEAR source index and float weights per output index."""
    scale = src / dst
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(f32)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0, src - 1
    return sx, np.minimum(sx + 1, src - 1), fx


def _resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a float32 map
    with one or more channels in its last axis; an exact 2x downscale is cv2's
    2x2 area average."""
    h0, w0 = img.shape[:2]
    if (h0, w0) == (h, w):
        return img.copy()
    if w0 == 2 * w and h0 == 2 * h:
        a = img[0::2, 0::2] + img[1::2, 0::2]
        b = img[0::2, 1::2] + img[1::2, 1::2]
        return (a + b) * f32(0.25)
    x0, x1, ax = _linear_taps(w0, w)
    y0, y1, ay = _linear_taps(h0, h)
    ax = ax.reshape((1, -1) + (1,) * (img.ndim - 2))
    ay = ay.reshape((-1,) + (1,) * (img.ndim - 1))
    hor = img[:, x0] * (f32(1) - ax) + img[:, x1] * ax
    return hor[y0] * (f32(1) - ay) + hor[y1] * ay


# ---------------------------------------------------------------- Farneback
@functools.lru_cache(maxsize=4)
def _poly_gaussian(n: int, sigma: float):
    """``FarnebackPrepareGaussian``: the float kernels g, x g, x^2 g over
    [-n, n] and four entries of the inverse Gram matrix (double)."""
    x = np.arange(-n, n + 1)
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(f32)
    g = (g.astype(np.float64) * (1.0 / g.astype(np.float64).sum())).astype(f32)
    xg = (x.astype(f32) * g).astype(f32)
    xxg = ((x * x).astype(f32) * g).astype(f32)
    gg = g[:, None] * g[None, :]                                  # float products [y, x]
    xf = x.astype(f32)[None, :]
    yf = x.astype(f32)[:, None]
    G = np.zeros((6, 6))
    G[0, 0] = gg.astype(np.float64).sum()
    G[1, 1] = (gg * xf * xf).astype(np.float64).sum()
    G[3, 3] = (gg * xf * xf * xf * xf).astype(np.float64).sum()
    G[5, 5] = (gg * xf * xf * yf * yf).astype(np.float64).sum()
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    inv = np.linalg.inv(G)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def _poly_exp(src: np.ndarray, n: int, sigma: float) -> np.ndarray:
    """``FarnebackPolyExp``: (H, W) float32 -> (H, W, 5) float32 coefficients
    (y, x, yy, xx, xy order as cv2 stores them)."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_gaussian(n, sigma)
    h, w = src.shape
    rows = np.clip(np.arange(-n, h + n), 0, h - 1)
    s = src[rows]                                                 # replicated rows
    r0 = s[n:n + h] * g[n]
    r1 = np.zeros_like(r0)
    r2 = np.zeros_like(r0)
    for k in range(1, n + 1):
        up, down = s[n - k:n - k + h], s[n + k:n + k + h]
        p = up + down
        r0 = r0 + g[n + k] * p
        r1 = r1 + xg[n + k] * (down - up)
        r2 = r2 + xxg[n + k] * p
    cols = np.clip(np.arange(-n, w + n), 0, w - 1)
    r0, r1, r2 = r0[:, cols], r1[:, cols], r2[:, cols]           # replicated columns
    d = np.float64
    b1 = (r0[:, n:n + w] * g[n]).astype(d)
    b3 = (r1[:, n:n + w] * g[n]).astype(d)
    b5 = (r2[:, n:n + w] * g[n]).astype(d)
    b2 = np.zeros((h, w))
    b4 = np.zeros((h, w))
    b6 = np.zeros((h, w))
    for k in range(1, n + 1):
        lo, hi = slice(n - k, n - k + w), slice(n + k, n + k + w)
        tg = (r0[:, hi] + r0[:, lo]).astype(d)
        b1 += tg * d(g[n + k])
        b4 += tg * d(xxg[n + k])
        b2 += (r0[:, hi] - r0[:, lo]).astype(d) * d(xg[n + k])
        b3 += (r1[:, hi] + r1[:, lo]).astype(d) * d(g[n + k])
        b6 += (r1[:, hi] - r1[:, lo]).astype(d) * d(xg[n + k])
        b5 += (r2[:, hi] + r2[:, lo]).astype(d) * d(g[n + k])
    return np.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33, b1 * ig03 + b4 * ig33,
                     b6 * ig55], axis=-1).astype(f32)


def _update_matrices(r0: np.ndarray, r1: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """``FarnebackUpdateMatrices``: (H, W, 5) float32, the blurred system's
    inputs G11, G12, G22, h1, h2 at every pixel."""
    h, w = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    fx = np.arange(w, dtype=f32)[None, :] + dx
    fy = np.arange(h, dtype=f32)[:, None] + dy
    x1 = np.floor(fx).astype(np.int64)
    y1 = np.floor(fy).astype(np.int64)
    fx = fx - x1.astype(f32)
    fy = fy - y1.astype(f32)
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    base = np.where(inside, y1 * w + x1, 0)
    one = f32(1)
    a00, a01 = ((one - fx) * (one - fy))[..., None], (fx * (one - fy))[..., None]
    a10, a11 = ((one - fx) * fy)[..., None], (fx * fy)[..., None]
    flat = r1.reshape(-1, 5)
    samp = (a00 * flat[base] + a01 * flat[base + 1] + a10 * flat[base + w]
            + a11 * flat[base + w + 1])
    samp = [samp[..., c] for c in range(5)]
    half, quarter = f32(0.5), f32(0.25)
    r2 = np.where(inside, samp[0], f32(0))
    r3 = np.where(inside, samp[1], f32(0))
    r4 = np.where(inside, (r0[..., 2] + samp[2]) * half, r0[..., 2])
    r5 = np.where(inside, (r0[..., 3] + samp[3]) * half, r0[..., 3])
    r6 = np.where(inside, (r0[..., 4] + samp[4]) * quarter, r0[..., 4] * half)
    r2 = (r0[..., 0] - r2) * half
    r3 = (r0[..., 1] - r3) * half
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    nb = len(_BORDER)
    edge = np.zeros((h, w), bool)
    edge[:nb], edge[-nb:], edge[:, :nb], edge[:, -nb:] = True, True, True, True
    scale = _border_scale(h, w)
    r2, r3, r4, r5, r6 = (np.where(edge, v * scale, v) for v in (r2, r3, r4, r5, r6))
    return np.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], axis=-1)


@functools.lru_cache(maxsize=8)
def _border_scale(h: int, w: int) -> np.ndarray:
    """The border damping of ``FarnebackUpdateMatrices``, its float products
    in cv2's order."""
    nb = len(_BORDER)
    xs, ys = np.arange(w), np.arange(h)
    fa = np.where(xs < nb, _BORDER[np.minimum(xs, nb - 1)], f32(1))
    fb = np.where(xs >= w - nb, _BORDER[np.clip(w - xs - 1, 0, nb - 1)], f32(1))
    fc = np.where(ys < nb, _BORDER[np.minimum(ys, nb - 1)], f32(1))
    fd = np.where(ys >= h - nb, _BORDER[np.clip(h - ys - 1, 0, nb - 1)], f32(1))
    return ((fa * fb)[None, :] * fc[:, None]) * fd[:, None]


@functools.lru_cache(maxsize=4)
def _flow_kernel(block_size: int) -> np.ndarray:
    """``FarnebackUpdateFlow_GaussianBlur``'s float kernel over [0, m]."""
    m = block_size // 2
    sigma = m * 0.3
    k = [f32(1.0)] + [f32(np.exp(-i * i / (2 * sigma * sigma))) for i in range(1, m + 1)]
    s = 1.0 + sum(2.0 * float(t) for t in k[1:])
    return np.array([f32(float(t) * (1.0 / s)) for t in k], f32)


def _update_flow(mats: np.ndarray, block_size: int) -> np.ndarray:
    """Blur the five maps with replicated borders (vertical, then horizontal)
    and solve each pixel's 2x2 system in double; (H, W, 2) float32."""
    k = _flow_kernel(block_size)
    m = len(k) - 1
    h, w = mats.shape[:2]
    src = mats[np.clip(np.arange(-m, h + m), 0, h - 1)]
    v = src[m:m + h] * k[0]
    for i in range(1, m + 1):
        v = v + (src[m + i:m + i + h] + src[m - i:m - i + h]) * k[i]
    v = v[:, np.clip(np.arange(-m, w + m), 0, w - 1)]
    s = v[:, m:m + w] * k[0]
    for i in range(1, m + 1):
        s = s + k[i] * (v[:, m - i:m - i + w] + v[:, m + i:m + i + w])
    g11, g12, g22, h1, h2 = (s[..., c].astype(np.float64) for c in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return np.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet],
                    axis=-1).astype(f32)


def _update_flow_box(mats: np.ndarray, block_size: int) -> np.ndarray:
    """``FarnebackUpdateFlow_Blur``: the five maps box-summed over
    block_size x block_size with replicated borders, as cv2's running sums
    compute them (each row's sum steps by the float difference of the rows
    that enter and leave, kept in double; each column's by the double
    difference), times 1 / block_size^2; the 2x2 system solved per pixel in
    double; (H, W, 2) float32. cv2 updates the matrices in stripes behind
    the sweep, rows that have left the window, so the result equals a sweep
    over all rows followed by the update."""
    m = block_size // 2
    h, w = mats.shape[:2]
    mats = mats.astype(f32)
    rows = np.empty((h, w, 5))
    v = (mats[0] * f32(m + 2)).astype(np.float64)
    for y in range(1, m):
        v += mats[min(y, h - 1)]
    for y in range(h):
        v = v + (mats[min(y + m, h - 1)] - mats[max(y - m - 1, 0)]).astype(np.float64)
        rows[y] = v
    pad = np.concatenate([np.repeat(rows[:, :1], m + 1, axis=1), rows,
                          np.repeat(rows[:, -1:], m + 1, axis=1)], axis=1)   # x -> x + m + 1
    s = rows[:, 0] * (m + 2)
    for x in range(1, m):
        s = s + pad[:, x + m + 1]
    sums = np.empty((h, w, 5))
    for x in range(w):
        s = s + (pad[:, x + 2 * m + 1] - pad[:, x])
        sums[:, x] = s
    scale = 1.0 / (block_size * block_size)
    g11, g12, g22, h1, h2 = (sums[..., c] * scale for c in range(5))
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return np.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet],
                    axis=-1).astype(f32)


def farneback_flow(prev: np.ndarray, nxt: np.ndarray, pyr_scale: float = 0.5, levels: int = 5,
                   winsize: int = 10, iterations: int = 2, poly_n: int = 7,
                   poly_sigma: float = 1.5, flags: int = OPTFLOW_FARNEBACK_GAUSSIAN
                   ) -> np.ndarray:
    """Flow (H, W, 2) float32, (dx, dy) per pixel, from ``prev`` to ``nxt``
    (uint8 or float (H, W) frames of at least 32x32), as
    ``cv2.calcOpticalFlowFarneback`` with the same arguments (no initial
    flow); ``flags`` is ``OPTFLOW_FARNEBACK_GAUSSIAN`` or 0."""
    if flags not in (0, OPTFLOW_FARNEBACK_GAUSSIAN):
        raise ValueError(f"farneback_flow takes flags 0 or OPTFLOW_FARNEBACK_GAUSSIAN, not {flags}")
    update = _update_flow if flags else _update_flow_box
    h0, w0 = prev.shape
    n_levels, scale = 0, 1.0
    while n_levels < levels:
        scale *= pyr_scale
        if w0 * scale < _MIN_SIZE or h0 * scale < _MIN_SIZE:
            break
        n_levels += 1
    frames = [np.asarray(prev).astype(f32), np.asarray(nxt).astype(f32)]
    flow = None
    for k in range(n_levels, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1) * 0.5
        smooth = max(int(np.rint(sigma * 5)) | 1, 3)
        width, height = int(np.rint(w0 * scale)), int(np.rint(h0 * scale))
        if flow is None:
            flow = np.zeros((height, width, 2), f32)
        else:
            flow = (_resize_linear(flow, width, height).astype(np.float64)
                    * (1.0 / pyr_scale)).astype(f32)
        r = [_poly_exp(_resize_linear(_gaussian_blur(f, smooth, sigma), width, height),
                       poly_n, poly_sigma) for f in frames]
        mats = _update_matrices(r[0], r[1], flow)
        for i in range(iterations):
            flow = update(mats, winsize)
            if i < iterations - 1:
                mats = _update_matrices(r[0], r[1], flow)
    return flow
