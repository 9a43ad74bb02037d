"""The eval preprocessing tail as torch ops on the sample's device (port of
``maggie_tpu/data/device_pipeline.py``).

The host keeps image decoding; the device runs the rest of the eval transform
chain: short-side bilinear resize, pad to a multiple of 64, ImageNet
normalization, nearest mask resize and the /8 mask downscale. Used only with
``dataset.test.device_preprocess``; the host chain (``data/transforms.py``)
stays the reference.

- At ratio 1 (the source already at eval size) there is no resize, and the
  normalization is a lookup in a 256-entry table built on the host with the
  host chain's float32 operations, so the model input is bit-equal to the host
  chain's.
- Otherwise the frame is resized in float32 (half-pixel bilinear,
  ``ops/resize.py``), which differs from cv2's fixed-point uint8 resize by up to
  about one grey level (the JAX file's tolerance).
- Mask resizes use cv2's nearest index maps (``data/imgproc.py``), bit-exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops.resize import resize_bilinear_nhwc
from .imgproc import nearest_index
from .transforms import IMAGENET_MEAN, IMAGENET_STD, Normalize


@functools.lru_cache(maxsize=1)
def _normalize_lut() -> np.ndarray:
    """(256, 3) f32 table: the host chain's ``Normalize`` of every uint8 value."""
    return Normalize()({"frames": np.arange(256, dtype=np.float32)[:, None]})["frames"]


def device_preprocess_eval(frame_u8: np.ndarray, masks_u8: np.ndarray, short_size: int,
                           divisor: int = 64, downscale_mask: bool = True, device=None):
    """frame_u8 (H0, W0, 3) uint8 RGB; masks_u8 (n_i, H0, W0) uint8 0/255.
    Returns (image (1, Hp, Wp, 3) f32, mask (1, n_i, h, w) f32, transform_info),
    the tensors on ``device`` (CUDA unless the caller passes "cpu")."""
    dev = resolve_device(device)
    h0, w0 = frame_u8.shape[:2]
    ratio = short_size * 1.0 / min(w0, h0)
    oh, ow = (int(h0 * ratio), int(w0 * ratio)) if ratio != 1 else (h0, w0)
    ph = (divisor - oh % divisor) % divisor
    pw = (divisor - ow % divisor) % divisor
    hp, wp = oh + ph, ow + pw

    frame = torch.from_numpy(np.ascontiguousarray(frame_u8)).to(dev)
    if (oh, ow) != (h0, w0):
        f = resize_bilinear_nhwc(frame.float()[None], (oh, ow), align_corners=False)[0]
        f = torch.nn.functional.pad(f, (0, 0, 0, pw, 0, ph))
        mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
        std = torch.from_numpy(IMAGENET_STD).to(dev)
        f = (f / 255.0 - mean) / std
    else:
        # pad the raw uint8 first (the host pads before Normalize, so the pad
        # region is normalize(0) there too), then look each value up
        fu = torch.nn.functional.pad(frame, (0, 0, 0, pw, 0, ph)).long()
        lut = torch.from_numpy(_normalize_lut()).to(dev)
        f = lut[fu, torch.arange(3, device=dev)]

    def take(x, dim, idx):
        return x.index_select(dim, torch.from_numpy(idx).to(dev))

    m = torch.from_numpy(np.ascontiguousarray(masks_u8)).to(dev)
    m = take(take(m, 1, nearest_index(h0, oh)), 2, nearest_index(w0, ow))
    m = torch.nn.functional.pad(m, (0, pw, 0, ph))
    if downscale_mask:
        m = take(take(m, 1, nearest_index(hp, hp // 8)), 2, nearest_index(wp, wp // 8))
    m = m.float() / 255.0
    info = [{"name": "resize", "ori_size": (h0, w0), "ratio": ratio},
            {"name": "padding", "pad_size": (ph, pw)}]
    return f[None], m[None], info
