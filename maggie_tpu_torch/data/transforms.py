"""Image transforms (port of the image classes of ``maggie_tpu/data/transforms.py``;
reference ``maggie/dataloader/transforms.py``), numpy only.

cv2 is replaced by ``data/imgproc.py`` (bit-exact for the calls made here), and
images are decoded by a function the caller may pass to ``Load``; the default
decodes with PIL, imported on the first decode. The train augmentations of
the HIM set draw from the dataset's ``numpy.random.RandomState`` in the JAX
package's order and count, so a seed gives its samples bit for bit. So do the
two video augmentations of the VIM train set (``MotionBlur``, ``MaskDropout``),
MotionBlur's pixels within one uint8 level of cv2's (``imgproc.filter2d``).

The seven transforms that no dataset uses (``ChooseOne`` through
``HistogramMatching``, at the end; ``tools/gen_mask.py`` runs
``ModifyMaskBoundary``) are bit-equal to the JAX package's under the same
``RandomState``. ``ModifyMaskBoundary`` and its walk also draw from numpy's
global generator where the JAX package does (``np.random.normal(0, 0.0)``
still takes a draw), so the global state after a call is its too.

Output layout is NHWC float32 (``frames``: (T, H, W, 3)). Geometry ops record
``transform_info`` entries for ``utils/postprocess.reverse_transform``.
"""

from __future__ import annotations

import math
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
    mode)``, which returns a uint8 array: (H, W, 3) for "RGB", (H, W) for "L".

    ``cache_gb`` > 0 keeps decoded arrays in host RAM up to that budget, as the
    JAX package's ``Load`` does (training epochs revisit the same files); a
    cached array is served as a copy, so in-place augmentations cannot change
    the cache."""

    def __init__(self, decode: Callable[[str, str], np.ndarray] | None = None,
                 cache_gb: float = 0.0):
        self._decode = decode or pil_decode
        self._cache: dict | None = {} if cache_gb > 0 else None
        self._budget = int(cache_gb * (1 << 30))
        self._bytes = 0

    def decode(self, path: str, mode: str) -> np.ndarray:
        if self._cache is None:
            return self._decode(path, mode)
        arr = self._cache.get((path, mode))
        if arr is None:
            arr = self._decode(path, mode)
            if self._bytes + arr.nbytes > self._budget:
                return arr  # over budget: serve the fresh decode
            self._cache[(path, mode)] = arr
            self._bytes += arr.nbytes
        return arr.copy()

    def __call__(self, d: dict) -> dict:
        d["frames"] = [self.decode(p, "RGB") for p in d["frames"]]
        d["alphas"] = [self.decode(p, "L") for p in d["alphas"]]
        if d.get("masks") is not None:
            d["masks"] = [self.decode(p, "L") for p in d["masks"]]
        return d


class ResizeShort:
    """Resize so the short side equals ``short_size`` (reference ``:104-135``);
    saves pre-resize alphas as ``ori_alphas`` and records the inverse info.
    With ``transform_alphas`` False the alphas keep their size (an eval set
    with guidance masks reads only ``ori_alphas``)."""

    def __init__(self, short_size: int, transform_alphas: bool = True):
        self.short_size = short_size
        self.transform_alphas = transform_alphas

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        d["ori_alphas"] = alphas
        h, w = frames[0].shape[:2]
        ratio = self.short_size * 1.0 / min(w, h)
        if ratio != 1:
            size = (int(w * ratio), int(h * ratio))
            frames = [imgproc.resize_linear(f, size) for f in frames]
            if self.transform_alphas:
                alphas = [imgproc.resize_linear(a, size) for a in alphas]
            if masks is not None:
                masks = [imgproc.resize_nearest(m, size) for m in masks]
        d["transform_info"].append({"name": "resize", "ori_size": (h, w), "ratio": ratio})
        d["frames"], d["alphas"], d["masks"] = frames, alphas, masks
        return d


class PaddingMultiplyBy:
    """Zero-pad bottom/right to a multiple of ``divisor`` (reference ``:137-166``);
    the alphas only with ``transform_alphas``."""

    def __init__(self, divisor: int = 32, transform_alphas: bool = True):
        self.divisor = divisor
        self.transform_alphas = transform_alphas

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        h, w = frames[0].shape[:2]
        ph = (self.divisor - h % self.divisor) % self.divisor
        pw = (self.divisor - w % self.divisor) % self.divisor
        d["frames"] = [imgproc.pad_bottom_right(f, ph, pw) for f in frames]
        if self.transform_alphas:
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


class RandomCropByAlpha:
    """Crop around the alpha region, or pad-to-square+resize with prob
    ``padding_prob`` (reference ``:191-274``)."""

    def __init__(self, crop_size, random, padding_prob=0.5):
        self.crop_size = tuple(crop_size)
        self.random = random
        self.padding_prob = padding_prob

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        h, w = frames[0].shape[:2]
        ch, cw = self.crop_size
        if h < ch or w < cw:
            raise ValueError(f"Crop size {self.crop_size} larger than image {(h, w)}")
        # mean(0) > 127 in integers: the same pixels, without a float64 pass
        ys, xs = np.where(alphas.sum(0, dtype=np.int32) > 127 * alphas.shape[0])
        if len(xs) > 0:
            min_x, max_x, min_y, max_y = xs.min(), xs.max(), ys.min(), ys.max()
        else:
            min_x, max_x, min_y, max_y = 0, w, 0, h

        if self.random.rand() > self.padding_prob:
            max_x = max(max_x - cw, min_x + 1)
            max_y = max(max_y - ch, min_y + 1)
            for _ in range(3):
                x = min(self.random.randint(min_x, max_x), w - cw)
                y = min(self.random.randint(min_y, max_y), h - ch)
                ca = alphas[:, y:y + ch, x:x + cw]
                if (ca > 127).sum() > 0:
                    break
            d["frames"] = frames[:, y:y + ch, x:x + cw, :]
            d["alphas"] = ca
            if masks is not None:
                d["masks"] = masks[:, y:y + ch, x:x + cw]
        else:
            if h > w:
                pw, ph = (h - w) // 2, 0
            else:
                pw, ph = 0, (w - h) // 2

            def pad(im):
                return imgproc.copy_make_border(im, ph, ph, pw, pw)
            # cv2's size is (w, h): the crop's (ch, cw) is read as cv2 reads it
            d["frames"] = np.stack([imgproc.resize_linear(pad(f), self.crop_size) for f in frames])
            d["alphas"] = np.stack([imgproc.resize_linear(pad(a), self.crop_size) for a in alphas])
            if masks is not None:
                d["masks"] = np.stack([imgproc.resize_nearest(pad(m), self.crop_size)
                                       for m in masks])
        return d


class RandomHorizontalFlip:
    def __init__(self, random, p=0.5):
        self.random, self.p = random, p

    def __call__(self, d: dict) -> dict:
        if self.random.rand() < self.p:
            d["frames"] = np.ascontiguousarray(d["frames"][:, :, ::-1, :])
            d["alphas"] = np.ascontiguousarray(d["alphas"][:, :, ::-1])
            if d.get("masks") is not None:
                d["masks"] = np.ascontiguousarray(d["masks"][:, :, ::-1])
        return d


class GammaContrast:
    """255*(x/255)^gamma with gamma ~ TruncNormal(1.0, 0.2) in [0.5, 1.5]
    (imgaug GammaContrast equivalent, reference ``:812-839``)."""

    def __init__(self, random, p=0.3):
        self.random, self.p = random, p

    def _gamma(self):
        for _ in range(100):
            g = self.random.normal(1.0, 0.2)
            if 0.5 <= g <= 1.5:
                return g
        return 1.0

    def __call__(self, d: dict) -> dict:
        if self.random.rand() > self.p:
            return d
        g = self._gamma()
        f = d["frames"].astype(np.float32) / 255.0
        d["frames"] = (np.power(f, g) * 255.0).astype(np.uint8)
        return d


class AdditiveGaussianNoise:
    """Additive N(0, s), s ~ U(0, 0.03*255) (imgaug equivalent, ``:865-891``)."""

    def __init__(self, random, p=0.3):
        self.random, self.p = random, p

    def __call__(self, d: dict) -> dict:
        if self.random.rand() > self.p:
            return d
        scale = self.random.uniform(0, 0.03 * 255)
        frames = d["frames"].astype(np.float32)
        noise = self.random.normal(0, scale, frames.shape).astype(np.float32)
        d["frames"] = np.clip(frames + noise, 0, 255).astype(np.uint8)
        return d


class JpegCompression:
    """JPEG round-trip at quality 100-c, c ~ U(20, 80) (imgaug equivalent,
    ``:893-920``), through PIL (``imgproc.jpeg_roundtrip``)."""

    def __init__(self, random, p=0.3):
        self.random, self.p = random, p

    def __call__(self, d: dict) -> dict:
        if self.random.rand() > self.p:
            return d
        quality = int(100 - self.random.uniform(20, 80))
        d["frames"] = np.stack([imgproc.jpeg_roundtrip(f, quality) for f in d["frames"]])
        return d


class MotionBlur:
    """Directional line blur with a kernel of 3 to 49 (albumentations
    MotionBlur equivalent, reference ``:975-1034``): one kernel, a line
    between two random points normalised to sum 1, for every frame and alpha
    of the stack."""

    def __init__(self, random, p=0.3):
        self.random, self.p = random, p

    def _kernel(self):
        k = int(self.random.randint(3, 50))
        if k % 2 == 0:
            k += 1
        kern = np.zeros((k, k), np.float32)
        x1, y1 = self.random.randint(0, k), self.random.randint(0, k)
        x2, y2 = self.random.randint(0, k), self.random.randint(0, k)
        imgproc.line(kern, (int(x1), int(y1)), (int(x2), int(y2)), 1.0)
        s = kern.sum()
        return kern / s if s > 0 else None

    def __call__(self, d: dict) -> dict:
        if self.random.rand() > self.p:
            return d
        kern = self._kernel()
        if kern is None:
            return d
        frames, alphas = d["frames"], d["alphas"]
        d["frames"] = np.clip(imgproc.filter2d(frames, kern), 0, 255).astype(np.uint8)
        d["alphas"] = np.clip(imgproc.filter2d(alphas, kern), 0, 255).astype(
            frames.dtype if alphas.dtype == np.uint8 else alphas.dtype)
        return d


class RandomAffine:
    """Small rotation/shear/zoom/channel-shift (reference ``:922-966``)."""

    def __init__(self, random, p=0.5):
        self.random, self.p = random, p

    def __call__(self, d: dict) -> dict:
        if self.random.rand() > self.p:
            return d
        from .utils import random_transform
        frames, alphas = d["frames"], d["alphas"]
        ys = random_transform(list(frames) + list(alphas), self.random, rt=10, sh=5,
                              zm=[0.95, 1.05], sc=[1, 1], cs=0.03 * 255.0, hf=False)
        d["frames"] = np.stack(ys[:len(frames)])
        d["alphas"] = np.stack(ys[len(frames):])
        return d


class RandomBinarizedMask:
    """Corrupt masks: random threshold + random dilate/erode (reference ``:388-464``)."""

    def __init__(self, random, binarize_max_k=30):
        self.random = random
        self.max_k = binarize_max_k

    def _single(self, alpha):
        threshold = self.random.uniform(0.1, 0.95) * 255
        binarized = (np.asarray(alpha) > threshold).astype(np.uint8)
        kd = self.random.randint(1, self.max_k)
        ke = self.random.randint(1, self.max_k)
        order = self.random.choice(["dilate_erode", "erode_dilate", "dilate", "erode"])
        if order == "dilate_erode":
            out = imgproc.erode_rect(imgproc.dilate_rect(binarized, kd), ke)
        elif order == "erode_dilate":
            out = imgproc.dilate_rect(imgproc.erode_rect(binarized, ke), kd)
        elif order == "dilate":
            out = imgproc.dilate_rect(binarized, kd)
        else:
            out = imgproc.erode_rect(binarized, ke)
        return out * 255

    def __call__(self, d: dict) -> dict:
        d["masks"] = np.stack([self._single(m) for m in d["masks"]], axis=0)
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


class CutMask:
    """Swap internal regions within a mask or between two instances (reference ``:499-534``)."""

    def __init__(self, random):
        self.random = random
        self.internal_perturb_prob = 0.5
        self.external_perturb_prob = 0.5

    def _internal(self, mask):
        if self.random.rand() < self.internal_perturb_prob:
            h, w = mask.shape
            ph, pw = self.random.randint(h // 8, h // 4), self.random.randint(w // 8, w // 4)
            x, y = self.random.randint(0, h - ph), self.random.randint(0, w - pw)
            x1, y1 = self.random.randint(0, h - ph), self.random.randint(0, w - pw)
            mask[x:x + ph, y:y + pw] = mask[x1:x1 + ph, y1:y1 + pw].copy()
        return mask

    def _external(self, mask):
        if self.random.rand() < self.external_perturb_prob and mask.shape[0] > 1:
            ids = self.random.choice(mask.shape[0], 2, replace=False)
            i, j = int(ids[0]), int(ids[1])
            h, w = mask.shape[-2:]
            ph, pw = self.random.randint(h // 8, h // 4), self.random.randint(w // 8, w // 4)
            x, y = self.random.randint(0, h - ph), self.random.randint(0, w - pw)
            a = mask[i, x:x + ph, y:y + pw].copy()
            b = mask[j, x:x + ph, y:y + pw].copy()
            mask[i, x:x + ph, y:y + pw] = b
            mask[j, x:x + ph, y:y + pw] = a
        return mask

    def __call__(self, d: dict) -> dict:
        if self.random.rand() < 0.5:
            d["masks"] = np.stack([self._internal(d["masks"][i])
                                   for i in range(d["masks"].shape[0])])
        else:
            d["masks"] = self._external(d["masks"])
        return d


class MaskDropout:
    """Zero a random box inside some instance masks of the stack (reference
    ``:536-565``); only for stacks of at least 6 maps."""

    def __init__(self, random):
        self.random = random

    def __call__(self, d: dict) -> dict:
        masks = d["masks"]
        if self.random.rand() < 0.5 or masks.shape[0] // 2 < 3:
            return d
        n = self.random.randint(1, masks.shape[0] // 2)
        for i in self.random.choice(masks.shape[0], n, replace=False):
            ys, xs = np.where(masks[i] > 0)
            if len(ys) == 0:
                continue
            xmin, xmax, ymin, ymax = xs.min(), xs.max(), ys.min(), ys.max()
            if (ymax - ymin + 1) // 8 < 2 or (xmax - xmin + 1) // 8 < 2:
                continue
            ph = self.random.randint((ymax - ymin + 1) // 16, (ymax - ymin + 1) // 8)
            pw = self.random.randint((xmax - xmin + 1) // 16, (xmax - xmin + 1) // 8)
            k = self.random.choice(range(len(ys)), 1)
            x, y = min(int(xs[k]), xmax - pw), min(int(ys[k]), ymax - ph)
            masks[i, y:y + ph, x:x + pw] = 0
        d["masks"] = masks
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


class ChooseOne:
    """Apply one randomly chosen transform (reference ``:28-36``)."""

    def __init__(self, random, transforms):
        self.random = random
        self.transforms = transforms

    def __call__(self, d: dict) -> dict:
        t = self.transforms[self.random.randint(len(self.transforms))]
        return t(d)


class RandomCenterCrop:
    """Random crop retaining the center region (reference ``:68-102``). As in
    the JAX package, the crop's x is taken from the height and its y from
    the width, so on a frame that is not square the crop is not centred."""

    def __init__(self, random):
        self.random = random

    def __call__(self, d: dict) -> dict:
        frames, alphas, masks = d["frames"], d["alphas"], d.get("masks")
        h, w = frames[0].shape[:2]
        margin_h = int(h * 0.25) + self.random.randint(0, int(h * 0.25))
        margin_w = int(w * 0.25) + self.random.randint(0, int(w * 0.25))
        x = h // 2 - margin_h
        y = w // 2 - margin_w
        nh, nw = margin_h * 2, margin_w * 2
        d["frames"] = [f[y:y + nh, x:x + nw] for f in frames]
        d["alphas"] = [a[y:y + nh, x:x + nw] for a in alphas]
        if masks is not None:
            d["masks"] = [m[y:y + nh, x:x + nw] for m in masks]
        return d


class MasksFromBinarizedAlpha:
    """masks = (alpha > t*255) * 255 when none given (reference ``:372-386``)."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold

    def __call__(self, d: dict) -> dict:
        if d.get("masks") is None:
            d["masks"] = [((a > self.threshold * 255).astype(np.uint8) * 255)
                          for a in d["alphas"]]
        return d


class LoadRandomBackground:
    """Load/blur/crop a random background for composition (reference
    ``:307-350``); the file is decoded with PIL."""

    def __init__(self, bg_paths, random, blur_p=0.5,
                 blur_kernel_size=(5, 15, 25), blur_sigma=(1.0, 1.5, 3.0, 5.0)):
        self.bg_paths = bg_paths
        self.random = random
        self.blur_p = blur_p
        self.blur_kernel_size = blur_kernel_size
        self.blur_sigma = blur_sigma

    def __call__(self, d: dict) -> dict:
        frames = d["frames"]
        bg = pil_decode(self.bg_paths[self.random.randint(len(self.bg_paths))], "RGB")
        if self.random.rand() < self.blur_p:
            ks = int(self.random.choice(self.blur_kernel_size))
            sigma = float(self.random.choice(self.blur_sigma))
            bg = imgproc.gaussian_blur_u8(bg, ks, sigma)
        h, w = frames[0].shape[:2]
        bh, bw = bg.shape[:2]
        x = self.random.randint(0, max(bw - w, 1))
        y = self.random.randint(0, max(bh - h, 1))
        bg = imgproc.resize_linear(bg[y:y + h, x:x + w], (w, h))
        d["fg"] = np.asarray(frames).astype(np.float32)
        d["bg"] = np.tile(bg[None].astype(np.float32), (len(frames), 1, 1, 1))
        return d


class ComposeBackground:
    """frames = fg*alpha + bg*(1-alpha) (reference ``:352-370``)."""

    def __call__(self, d: dict) -> dict:
        alphas = np.asarray(d["alphas"]).astype(np.float32) / 255.0
        fg = np.asarray(d["fg"]).astype(np.float32)
        bg = np.asarray(d["bg"]).astype(np.float32)
        comp = fg * alphas[..., None] + bg * (1 - alphas[..., None])
        d["frames"] = np.clip(comp, 0, 255).astype(np.uint8)
        return d


def _get_random_structure(size):
    """A random rectangle or ellipse of about ``size`` (numpy's global generator)."""
    choice = np.random.randint(1, 5)
    if choice == 1:
        return imgproc.structuring_element(imgproc.MORPH_RECT, (size, size))
    if choice == 2:
        return imgproc.structuring_element(imgproc.MORPH_ELLIPSE, (size, size))
    if choice == 3:
        return imgproc.structuring_element(imgproc.MORPH_ELLIPSE, (size, max(size // 2, 1)))
    return imgproc.structuring_element(imgproc.MORPH_ELLIPSE, (max(size // 2, 1), size))


def _perturb_seg(gt, iou_target=0.6):
    """Random dilate/erode walk until IoU drops (reference ``:599-630``); numpy's
    global generator."""
    h, w = gt.shape
    seg = ((gt > 127).astype(np.uint8)) * 255
    if h <= 2 or w <= 2:
        return seg
    gtb = seg.copy()

    def iou(a, b):
        inter = np.count_nonzero(a * b)
        union = np.count_nonzero(a + b)
        return (inter + 1e-6) / (union + 1e-6)

    for _ in range(250):
        for _ in range(4):
            lx, ly = np.random.randint(w), np.random.randint(h)
            lw, lh = np.random.randint(lx + 1, w + 1), np.random.randint(ly + 1, h + 1)
            if np.random.rand() < 0.25:
                seg[(ly + lh) // 2, (lx + lw) // 2] = np.random.randint(2) * 255
            size = np.random.randint(3, 10)
            kernel = _get_random_structure(size)
            region = seg[ly:lh, lx:lw]
            if region.size == 0:
                continue
            if np.random.rand() < 0.5:
                seg[ly:lh, lx:lw] = imgproc.dilate(region, kernel)
            else:
                seg[ly:lh, lx:lw] = imgproc.erode(region, kernel)
        if iou(seg, gtb) < iou_target:
            break
    return seg


class ModifyMaskBoundary:
    """Contour subsample/perturb + random morphology walk (reference ``:632-717``)."""

    def __init__(self, random, p=0.5, regional_sample_rate=0.1, sample_rate=0.1,
                 move_rate=0.0):
        self.random = random
        self.p = p
        self.regional_sample_rate = regional_sample_rate
        self.sample_rate = sample_rate
        self.move_rate = move_rate

    def _modify(self, image):
        if self.random.rand() < self.p:
            return image
        iou_target = self.random.rand() * 0.2 + 0.8
        contours = imgproc.find_contours_list(image)
        modified = []
        for contour in contours:
            if contour.shape[0] < 10:
                continue
            M = imgproc.contour_moments(contour)
            n = contour.shape[0]
            n_rm = int(n * self.regional_sample_rate)
            # the points whose cut of n_rm points spans the least distance,
            # in index order among equal distances (a stable sort)
            dist = ((contour[:n - n_rm] - contour[n_rm:]) ** 2).sum(axis=(1, 2))
            cands = np.argsort(dist, kind="stable")[:math.ceil(0.1 * len(dist))]
            start = int(cands[int(self.random.choice(np.arange(len(cands))))])
            contour = np.concatenate([contour[:start], contour[start + n_rm:]], 0)
            n = contour.shape[0]
            ids = self.random.choice(range(n), int(n * self.sample_rate), replace=False)
            ids.sort()
            mod = np.copy(contour[ids])
            if M["m00"] != 0:
                cx, cy = round(M["m10"] / M["m00"]), round(M["m01"] / M["m00"])
                for k, coor in enumerate(mod):
                    change = np.random.normal(0, self.move_rate)
                    x, y = coor[0]
                    mod[k] = [x + (x - cx) * change, y + (y - cy) * change]
            modified.append(mod)
        modified = [c for c in modified if len(c) > 0]
        if not modified:
            out = image.copy()
        else:
            out = imgproc.fill_contours(image.shape, modified)
        return _perturb_seg(out, iou_target)

    def __call__(self, d: dict) -> dict:
        d["masks"] = np.stack([self._modify(m) for m in d["masks"]], axis=0)
        return d


class HistogramMatching:
    """Blend fg/bg toward each other's histogram (reference ``:841-863``;
    per-channel quantile mapping, as in the JAX package)."""

    def __init__(self, random, p=0.3):
        self.random = random
        self.p = p

    @staticmethod
    def _match(src, ref):
        out = np.empty_like(src)
        for c in range(src.shape[-1]):
            s = src[..., c].ravel()
            r = ref[..., c].ravel()
            s_sort = np.argsort(s)
            out_c = np.empty_like(s)
            out_c[s_sort] = np.sort(r)[
                np.linspace(0, len(r) - 1, len(s)).astype(np.int64)]
            out[..., c] = out_c.reshape(src[..., c].shape)
        return out

    def __call__(self, d: dict) -> dict:
        if "bg" not in d or self.random.rand() > self.p:
            return d
        fg = np.asarray(d["fg"], np.float32)
        bg = np.asarray(d["bg"], np.float32)
        ratio = self.random.uniform(0, 0.5)
        if self.random.rand() < 0.05:
            d["bg"] = (self._match(bg, fg) * ratio + bg * (1 - ratio)).astype(np.uint8)
        else:
            fgm = (self._match(fg, bg) * ratio + fg * (1 - ratio)).astype(np.uint8)
            d["fg"] = fgm
            d["frames"] = fgm
        return d
