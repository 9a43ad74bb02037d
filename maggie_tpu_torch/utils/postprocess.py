"""Eval postprocessing (port of ``maggie_tpu/utils/postprocess.py``; reference
``maggie/utils/postprocessing.py``): transform-info inversion (unpad + resize
back, ``:36-64``) and keep-largest-connected-component of alpha > 0.05
(``:66-87``), on the host."""

from __future__ import annotations

import numpy as np

from ..ops.resize import resize_bilinear_np


def _reshape2d(x):
    return x.reshape(-1, *x.shape[-2:])


def reverse_transform(img: np.ndarray, transform_info: list[dict]) -> np.ndarray:
    """Replay recorded transforms backwards. img: (bs, ..., h, w) numpy.

    ``padding`` entries crop the recorded pad; ``resize`` entries bilinear-resize
    back to the original size with align_corners=True (reference ``:59``), on the
    host (``resize_bilinear_np``). Returns a new array: callers clamp it in place.
    """
    img_shape = list(img.shape)
    x = _reshape2d(img)
    for t in transform_info[::-1]:
        name = t["name"][0] if isinstance(t["name"], (list, tuple)) else t["name"]
        if name == "padding":
            pad_h, pad_w = [int(v) for v in t["pad_size"]]
            h, w = x.shape[-2:]
            x = x[:, : h - pad_h, : w - pad_w]
        elif name == "resize":
            h, w = [int(v) for v in t["ori_size"]]
            x = resize_bilinear_np(x, (h, w), align_corners=True)
            img_shape[-2:] = [h, w]
    return np.array(x.reshape(img_shape))


def postprocess(alpha: np.ndarray) -> np.ndarray:
    """Keep the largest connected component of each alpha map.

    The reference uses skimage.measure.label's DEFAULT connectivity here (full
    8-connectivity for 2D), unlike the Conn metric's connectivity=1, so the
    8-connectivity structure is passed to scipy.ndimage.label explicitly.
    """
    from scipy import ndimage
    shape = alpha.shape
    x = _reshape2d(alpha)
    out = []
    s8 = np.ones((3, 3), np.int32)
    for a in x:
        labels, num = ndimage.label((a > 0.05).astype(int), structure=s8)
        if num == 0:
            out.append(a)
            continue
        sizes = np.bincount(labels.ravel())[1:]
        out.append(a * (labels == (np.argmax(sizes) + 1)))
    return np.stack(out, axis=0).reshape(shape)
