"""Ground-truth and affine helpers of the data pipeline (port of
``maggie_tpu/data/utils.py``; reference ``maggie/dataloader/utils.py``). cv2's
ellipse dilation and erosion become the port's own host versions
(``ops/morphology.py``), and its ``warpAffine`` ``data/imgproc.py``'s."""

from __future__ import annotations

import numpy as np

from ..ops.morphology import grey_dilate_ellipse, grey_erode_ellipse
from . import imgproc


def gen_transition_gt(alphas: np.ndarray, masks: np.ndarray | None = None,
                      k_size: int = 25, iterations: int = 1) -> np.ndarray:
    """Transition band = (dilate - erode) > 0 with a cv2 ``MORPH_ELLIPSE``
    element applied ``iterations`` times, optionally OR'd with mask-alpha
    disagreement (reference ``utils.py:15-35``). alphas: (N, 1, H, W) float;
    returns (N, 1, H, W) f32. The iterations run as one pass with the
    Minkowski sum of the ellipses (``ops/morphology.py::ellipse_sum_runs``),
    which equals cv2's iterated result.

    The disagreement clause compares ``alphas > 127`` and ``masks == 255`` on
    [0,1]-scaled inputs at the reference's call sites, so it never fires there;
    it is kept as the JAX package keeps it (``maggie_tpu/data/utils.py:31-40``).
    """
    out = []
    for x in alphas:
        m = x[0].astype(np.float32)
        if not m.any():  # padded empty instance slot: band is identically zero
            out.append(np.zeros_like(m))
            continue
        dilated = grey_dilate_ellipse(m, k_size, iterations)
        eroded = grey_erode_ellipse(m, k_size, iterations)
        out.append(((dilated - eroded) > 0).astype(np.float32))
    trans = np.stack(out)[:, None]  # (N, 1, H, W)

    if masks is not None and ((masks == 255).any() or (alphas > 127).any()):
        if masks.shape[-1] != alphas.shape[-1]:
            masks = masks.repeat(8, axis=-1).repeat(8, axis=-2)
        diff = (alphas > 127) != (masks == 255)
        trans[diff > 0] = 1.0
    return trans


def gen_diff_mask(alphas: np.ndarray, k_size: int = 25, iterations: int = 1) -> np.ndarray:
    """``cv2.dilate`` of each map of (N, 1, H, W) as float32 with a
    ``MORPH_ELLIPSE`` element of ``k_size`` (an even width has cv2's anchor at
    ``k_size // 2``), ``iterations`` times (reference ``utils.py:37-40``);
    returns (N, 1, H, W) f32. An all-zero map dilates to zeros, and is not
    dilated."""
    out = np.zeros(alphas.shape, np.float32)
    for i, x in enumerate(alphas):
        m = x[0].astype(np.float32)
        if m.any():
            out[i, 0] = grey_dilate_ellipse(m, k_size, iterations)
    return out


def gen_transition_temporal_gt(alphas: np.ndarray, masks: np.ndarray | None = None,
                               k_size: int = 25, iterations: int = 1) -> np.ndarray:
    """The video transition band: each frame's (dilate - erode) > 0 band, from
    frame 1 on kept only where the alpha rose by more than 1/255 since the
    frame before (reference ``utils.py:37-59``); the disagreement clause as in
    ``gen_transition_gt``. alphas: (T, 1, H, W) float; returns (T, 1, H, W) f32."""
    temporal = (alphas[1:] - alphas[:-1]) > (1.0 / 255.0)
    out = []
    for i, x in enumerate(alphas):
        m = x[0].astype(np.float32)
        dilated = grey_dilate_ellipse(m, k_size, iterations)
        eroded = grey_erode_ellipse(m, k_size, iterations)
        tm = ((dilated - eroded) > 0).astype(np.float32)
        if i > 0:
            tm[~temporal[i - 1, 0]] = 0.0
        out.append(tm)
    trans = np.stack(out)[:, None]
    if masks is not None and ((masks == 255).any() or (alphas > 127).any()):
        up = masks.repeat(8, axis=-1).repeat(8, axis=-2)
        diff = (alphas > 127) != (up == 255)
        trans[diff > 0] = 1.0
    return trans


# ---------------- affine augmentation (reference utils.py:61-221) ----------------

def _transform_matrix_offset_center(matrix, x, y):
    o_x = float(x) / 2 + 0.5
    o_y = float(y) / 2 + 0.5
    offset = np.array([[1, 0, o_x], [0, 1, o_y], [0, 0, 1]])
    reset = np.array([[1, 0, -o_x], [0, 1, -o_y], [0, 0, 1]])
    return offset @ matrix @ reset


def _apply_transforms_cv(xs, M):
    """Each image through the 3x3 map ``M`` (row, column order), as
    ``cv2.warpAffine`` with the map flipped to (x, y) order: bilinear for
    (H, W, C) frames, nearest for (H, W) maps."""
    dsize = (xs[0].shape[1], xs[0].shape[0])
    cv_m = np.zeros_like(M[:2, :])
    cv_m[:2, :2] = np.flipud(np.fliplr(M[:2, :2]))
    cv_m[:2, 2] = np.flip(M[:2, 2], axis=0)
    return [imgproc.warp_affine(x, cv_m, dsize) for x in xs]


def _channel_shift(xs, intensity):
    ys = []
    for x in xs:
        if x.ndim == 3:
            lo, hi = np.min(x), np.max(x)
            ys.append(np.clip(x + intensity, lo, hi))
        else:
            ys.append(x)
    return ys


def random_transform(xs, rnd, rt=False, hs=False, ws=False, sh=False,
                     zm=(1, 1), sc=(1, 1), cs=False, hf=False):
    """Random affine over a list of HxWxC images / HxW masks (reference
    ``:121-221``); every draw comes from ``rnd``, in the JAX package's order."""
    h, w = xs[0].shape[0], xs[0].shape[1]
    theta = np.pi / 180 * rnd.uniform(-rt, rt) if rt else 0
    tx = rnd.uniform(-hs, hs) * h if hs else 0
    ty = rnd.uniform(-ws, ws) * w if ws else 0
    shear = np.pi / 180 * rnd.uniform(-sh, sh) if sh else 0
    if zm[0] == 1 and zm[1] == 1:
        zx = zy = 1
    else:
        zx, zy = rnd.uniform(zm[0], zm[1]), rnd.uniform(zm[0], zm[1])
    if not (sc[0] == 1 and sc[1] == 1):
        s = rnd.uniform(sc[0], sc[1])
        zx, zy = zx * s, zy * s

    M = None
    if theta != 0:
        M = np.array([[np.cos(theta), -np.sin(theta), 0],
                      [np.sin(theta), np.cos(theta), 0], [0, 0, 1]])
    if tx != 0 or ty != 0:
        shift = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1]])
        M = shift if M is None else M @ shift
    if shear != 0:
        if rnd.random() < 0.5:
            sm = np.array([[1, -np.sin(shear), 0], [0, np.cos(shear), 0], [0, 0, 1]])
        else:
            sm = np.array([[np.cos(shear), 0, 0], [np.sin(shear), 1, 0], [0, 0, 1]])
        M = sm if M is None else M @ sm
    if zx != 1 or zy != 1:
        zmat = np.array([[zx, 0, 0], [0, zy, 0], [0, 0, 1]])
        M = zmat if M is None else M @ zmat
    if M is not None:
        M = _transform_matrix_offset_center(M, h, w)
        xs = _apply_transforms_cv(xs, M)
    if cs:
        xs = _channel_shift(xs, rnd.uniform(-cs, cs))
    if hf and rnd.rand() < 0.5:
        xs = [np.ascontiguousarray(x[:, ::-1]) for x in xs]
    return xs
