"""Eval transforms (port of the eval classes of ``maggie_tpu/data/transforms.py``;
reference ``maggie/dataloader/transforms.py``), numpy only.

cv2 is replaced by ``data/imgproc.py`` (bit-exact for the calls made here), and
images are decoded by a function the caller may pass to ``Load``; the default
decodes with PIL, imported on the first decode. The train augmentations come
with the training slice (ROADMAP item 10).

Output layout is NHWC float32 (``frames``: (T, H, W, 3)). Geometry ops record
``transform_info`` entries for ``utils/postprocess.reverse_transform``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from . import imgproc


def pil_decode(path: str, mode: str) -> np.ndarray:
    """Decode an image file to a uint8 array in PIL ``mode`` ("RGB" or "L")."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.convert(mode))


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, d: dict) -> dict:
        d.setdefault("transform_info", [])
        for t in self.transforms:
            d = t(d)
        return d


class Load:
    """Decode image/alpha/mask paths (reference ``:38-66``) with ``decode(path,
    mode)``, which returns a uint8 array: (H, W, 3) for "RGB", (H, W) for "L"."""

    def __init__(self, decode: Callable[[str, str], np.ndarray] | None = None):
        self.decode = decode or pil_decode

    def __call__(self, d: dict) -> dict:
        d["frames"] = [self.decode(p, "RGB") for p in d["frames"]]
        d["alphas"] = [self.decode(p, "L") for p in d["alphas"]]
        if d.get("masks") is not None:
            d["masks"] = [self.decode(p, "L") for p in d["masks"]]
        return d


class ResizeShort:
    """Resize so the short side equals ``short_size`` (reference ``:104-135``);
    saves pre-resize alphas as ``ori_alphas`` and records the inverse info."""

    def __init__(self, short_size: int):
        self.short_size = short_size

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        d["ori_alphas"] = alphas
        h, w = frames[0].shape[:2]
        ratio = self.short_size * 1.0 / min(w, h)
        if ratio != 1:
            size = (int(w * ratio), int(h * ratio))
            frames = [imgproc.resize_linear(f, size) for f in frames]
            alphas = [imgproc.resize_linear(a, size) for a in alphas]
            if masks is not None:
                masks = [imgproc.resize_nearest(m, size) for m in masks]
        d["transform_info"].append({"name": "resize", "ori_size": (h, w), "ratio": ratio})
        d["frames"], d["alphas"], d["masks"] = frames, alphas, masks
        return d


class PaddingMultiplyBy:
    """Zero-pad bottom/right to a multiple of ``divisor`` (reference ``:137-166``)."""

    def __init__(self, divisor: int = 32):
        self.divisor = divisor

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        h, w = frames[0].shape[:2]
        ph = (self.divisor - h % self.divisor) % self.divisor
        pw = (self.divisor - w % self.divisor) % self.divisor
        d["frames"] = [imgproc.pad_bottom_right(f, ph, pw) for f in frames]
        d["alphas"] = [imgproc.pad_bottom_right(a, ph, pw) for a in alphas]
        if masks is not None:
            d["masks"] = [imgproc.pad_bottom_right(m, ph, pw) for m in masks]
        d["transform_info"].append({"name": "padding", "pad_size": (ph, pw)})
        return d


class Stack:
    def __call__(self, d: dict) -> dict:
        d["frames"] = np.stack(d["frames"], axis=0)
        d["alphas"] = np.stack(d["alphas"], axis=0)
        if d.get("masks") is not None:
            d["masks"] = np.stack(d["masks"], axis=0)
        return d


class GenMaskFromAlpha:
    """masks = (alpha > 127) * 255 (reference ``:466-478``)."""

    def __call__(self, d: dict) -> dict:
        d["masks"] = ((np.asarray(d["alphas"]) > 127) * 255).astype(np.uint8)
        return d


class DownUpMask:
    """Down-up resample masks by ``ratio`` then re-binarize (reference ``:480-497``)."""

    def __init__(self, random, ratio, p=0.5):
        self.random, self.ratio, self.p = random, ratio, p

    def _single(self, m):
        if self.random.rand() < self.p:
            h, w = m.shape[:2]
            small = imgproc.resize_scale(m, self.ratio)
            m = imgproc.resize_linear(small, (w, h))
            m = (m > 127).astype(np.uint8) * 255
        return m

    def __call__(self, d: dict) -> dict:
        d["masks"] = np.stack([self._single(m) for m in d["masks"]], axis=0)
        return d


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ToNumpy:
    """Final packaging (reference ``ToTensor``, ``:720-770``): frames to float NHWC,
    alphas/masks reshaped (T*n_i, H, W) -> (T, n_i, H, W); alphas < 5 zeroed."""

    def __call__(self, d: dict) -> dict:
        frames = np.ascontiguousarray(d["frames"]).astype(np.float32)  # (T, H, W, 3)
        alphas = np.ascontiguousarray(d["alphas"]).astype(np.float32)
        n_inst = alphas.shape[0] // frames.shape[0]
        alphas = alphas.reshape(frames.shape[0], n_inst, *alphas.shape[1:])
        alphas[alphas < 5] = 0
        d["frames"], d["alphas"] = frames, alphas
        if d.get("masks") is not None:
            masks = np.ascontiguousarray(d["masks"]).astype(np.uint8)
            d["masks"] = masks.reshape(frames.shape[0], n_inst, *masks.shape[1:])
        if "ori_alphas" in d:
            oa = d["ori_alphas"]
            oa = np.ascontiguousarray(np.stack(oa) if isinstance(oa, list) else oa)
            d["ori_alphas"] = oa.reshape(frames.shape[0], n_inst, *oa.shape[1:]).astype(np.float32)
        return d


class Normalize:
    """ImageNet normalization of frames (reference ``:772-810``; its fg/bg
    derivation is omitted, as in the JAX package: nothing downstream reads it).
    The float32 operations and their order are the JAX package's, so the model
    input is bit-equal to its."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, d: dict) -> dict:
        f = d["frames"] / 255.0
        d["frames"] = ((f - self.mean) / self.std).astype(np.float32)
        return d
