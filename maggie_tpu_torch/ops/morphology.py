"""Elliptical dilation and uncertainty-region extraction.

Port of ``maggie_tpu/ops/morphology.py``. The cv2 ``MORPH_ELLIPSE`` structuring
element is reproduced bit-exactly (cv2's banker's rounding and even-width anchor
asymmetry included), and the dilation of a 0/1 map is the max over the
element's row runs of vertically shifted horizontal run-maxes.

``grey_dilate_runs`` and ``grey_erode_runs`` are cv2's dilation and erosion
of host maps by an element given by its row runs: the ellipse, the Minkowski
sum of ``iterations`` ellipses (cv2's iterated morphology in one pass,
``ellipse_sum_runs``) or a rectangle; the data pipeline's transition band and
mask corruption use them.

Eval-mode ``compute_unknown`` (threshold, then this dilation) lives beside its
CUDA kernel in ``ops/kernels/unknown.py``. Train mode draws a random width per
map (``compute_unknown_random``): one grouped convolution with a bank of the
elements of every width, in plain torch as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..parallel import space

LOWER_THRES = 1.0 / 255.0
UPPER_THRES = 254.0 / 255.0


@functools.lru_cache(maxsize=64)
def ellipse_kernel(width: int, height: int | None = None) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (width, height)) replica;
    ``height`` defaults to ``width``. cv2 takes the half-axes ``width // 2``
    and ``height // 2`` and one run a row, so a height of 1 keeps only the
    centre pixel, as in cv2."""
    height = width if height is None else height
    r = height // 2
    c = width // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    k = np.zeros((height, width), dtype=np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            # cv2 uses saturate_cast<int> == round-half-to-even on the double
            dx = int(np.round(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
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


@functools.lru_cache(maxsize=64)
def _embedded_offset_kernel(width: int, buf: int) -> np.ndarray:
    """The width-sized element in a (buf, buf) kernel centred on its anchor:
    entry [buf//2 + dy, buf//2 + dx] = SE[anchor + (dy, dx)], anchor = width//2
    (cv2's default). ``buf`` is odd and at least the element's offset span."""
    se = ellipse_kernel(width)
    a = width // 2
    out = np.zeros((buf, buf), dtype=np.float32)
    for sy, sx in zip(*np.nonzero(se)):
        out[buf // 2 + sy - a, buf // 2 + sx - a] = 1.0
    return out


def dilate_ellipse_random(binary: torch.Tensor, k_size: int,
                          generator: torch.Generator | None = None,
                          widths: torch.Tensor | None = None) -> torch.Tensor:
    """Dilate each 0/1 map of (..., H, W) with a cv2 ellipse of its own width
    in [1, k_size): the train-mode branch of ``compute_unknown`` (reference
    ``maggie/utils/utils.py:46-47``, ``np.random.randint(1, k_size)`` per map;
    ``maggie_tpu/ops/morphology.py:146-170``). The widths are ``widths`` (one
    per map) when given, else drawn from ``generator``. One grouped conv with
    each map's element from a bank of every width; the 0/1 products sum to
    whole numbers, which the threshold at 0.5 reads exactly whatever the
    convolution algorithm's rounding."""
    lead = binary.shape[:-2]
    n = int(np.prod(lead)) if lead else 1
    h, w = binary.shape[-2:]
    buf = max(k_size - 1 if (k_size - 1) % 2 == 1 else k_size, 3)
    bank = torch.from_numpy(np.stack([_embedded_offset_kernel(wd, buf) for wd in range(1, k_size)]))
    if widths is None:
        if generator is None:
            raise ValueError("dilate_ellipse_random needs widths or a torch.Generator")
        # the global batch's maps under data parallelism, then this rank's
        widths = parallel.shard_draw(lambda shape: torch.randint(
            1, k_size, shape, generator=generator, device=generator.device), (n,))
    kernels = bank.to(binary.device)[widths.to(binary.device) - 1]          # (n, buf, buf)
    y = F.conv2d(binary.reshape(1, n, h, w).float(), kernels[:, None], padding=buf // 2, groups=n)
    return (y > 0.5).reshape(binary.shape).to(binary.dtype)


def compute_unknown_random(masks: torch.Tensor, k_size: int,
                           generator: torch.Generator | None = None) -> torch.Tensor:
    """Train-mode uncertainty region: threshold to (1/255, 254/255) in f32, then
    ``dilate_ellipse_random``; a 0/1 map in the input dtype, without gradient.
    Row-sharded, the band's rows of the whole frame's map (``space.rows_op``)."""
    lo, hi = float(np.float32(LOWER_THRES)), float(np.float32(UPPER_THRES))

    def unknown(m):
        uncertain = ((m > lo) & (m < hi)).float()
        return dilate_ellipse_random(uncertain, k_size, generator).to(m.dtype)
    # on a band of a row-sharded frame: the element's reach (under k_size // 2)
    # of neighbour rows, zero padding beyond the frame as on one process
    return space.rows_op(masks, k_size // 2, unknown)


@functools.lru_cache(maxsize=64)
def ellipse_sum_runs(width: int, iterations: int = 1) -> tuple[tuple[int, int, int], ...]:
    """Row runs (dy, a, b) of the Minkowski sum of ``iterations`` copies of the
    cv2 ``MORPH_ELLIPSE`` element of ``width``, each at its anchor ``width // 2``
    (so the sum's anchor is ``(width // 2) * iterations``). One dilation with
    this element equals cv2's ``iterations`` dilations with the ellipse, and
    likewise for erosion, also at the borders, which cv2 ignores. Each row of
    the sum is one run: the ellipse's runs are nested intervals, so the spans
    that land on a row overlap."""
    base = _ellipse_row_runs(width)
    rows = {0: (0, 0)}
    for _ in range(iterations):
        nxt: dict[int, tuple[int, int]] = {}
        for y, (lo, hi) in rows.items():
            for dy, a, b in base:
                cur = nxt.get(y + dy)
                span = (lo + a, hi + b)
                nxt[y + dy] = span if cur is None else (min(cur[0], span[0]), max(cur[1], span[1]))
        rows = nxt
    return tuple((dy, a, b) for dy, (a, b) in sorted(rows.items()))


def _order_flip(x: np.ndarray) -> np.ndarray:
    """An order-reversing map of ``x``'s values onto its own dtype."""
    return ~x if np.issubdtype(x.dtype, np.unsignedinteger) else -x


def grey_dilate_runs(x: np.ndarray, runs: tuple[tuple[int, int, int], ...]) -> np.ndarray:
    """``cv2.dilate`` of maps (..., H, W) with the element given by its row runs
    ``(dy, a, b)``: out[y, x] = max of in[y + dy, x + a .. x + b] over the runs,
    pixels outside the map ignored, as cv2 ignores them. Float maps are padded
    with -inf, unsigned ones with 0. Each run's horizontal max comes from a
    doubling table (max over 1, 2, 4, ... columns; two lookups per run), then
    one vertical max per row of the element."""
    if len(runs) == 1 and runs[0] == (0, 0, 0):
        return x
    fill = -np.inf if np.issubdtype(x.dtype, np.floating) else np.iinfo(x.dtype).min
    H, W = x.shape[-2:]
    lead = x.shape[:-2]
    left, right = max(0, max(-a for _, a, _ in runs)), max(0, max(b for _, _, b in runs))
    up, down = max(0, max(-dy for dy, _, _ in runs)), max(0, max(dy for dy, _, _ in runs))
    table = [np.full(lead + (H, left + W + right), fill, x.dtype)]
    table[0][..., left:left + W] = x
    span = 1
    while 2 * span <= max(b - a + 1 for _, a, b in runs):
        t = table[-1]
        table.append(np.maximum(t[..., :-span], t[..., span:]))
        span *= 2
    out = np.full(lead + (H, W), fill, x.dtype)
    hrun = np.full(lead + (up + H + down, W), fill, x.dtype)
    for a, b in dict.fromkeys((a, b) for _, a, b in runs):
        k = (b - a + 1).bit_length() - 1
        lo, hi = left + a, left + b - (1 << k) + 1
        np.maximum(table[k][..., lo:lo + W], table[k][..., hi:hi + W],
                   out=hrun[..., up:up + H, :])
        for dy, a2, b2 in runs:
            if (a2, b2) == (a, b):
                np.maximum(out, hrun[..., up + dy:up + dy + H, :], out=out)
    return out


def grey_erode_runs(x: np.ndarray, runs: tuple[tuple[int, int, int], ...]) -> np.ndarray:
    """``cv2.erode`` with the same element: the min over it of in-map pixels."""
    return _order_flip(grey_dilate_runs(_order_flip(x), runs))


def grey_dilate_ellipse(x: np.ndarray, width: int, iterations: int = 1) -> np.ndarray:
    """``cv2.dilate(x, MORPH_ELLIPSE(width), iterations=iterations)`` of float32
    maps (..., H, W), on the host, in one pass (``ellipse_sum_runs``).

    Pixels outside the map are ignored, as cv2 ignores them, by padding with
    -inf: the zero padding of ``dilate_ellipse`` is exact only for maps that
    are 0 or above, and would break ``grey_erode_ellipse``, which dilates the
    negated map."""
    if width <= 1 or iterations < 1:
        return x
    return grey_dilate_runs(x, ellipse_sum_runs(width, iterations))


def grey_erode_ellipse(x: np.ndarray, width: int, iterations: int = 1) -> np.ndarray:
    """``cv2.erode(x, MORPH_ELLIPSE(width), iterations=iterations)`` of float32
    maps: the dual of ``grey_dilate_ellipse``, the min over the element of
    in-map pixels."""
    if width <= 1 or iterations < 1:
        return x
    return grey_erode_runs(x, ellipse_sum_runs(width, iterations))
