"""HIM image instance-matting dataset, eval branch (port of
``maggie_tpu/data/him.py``; reference ``maggie/dataloader/him.py``).

Directory contract of the eval split (reference ``docs/DATASET.md:68-107``):
root/images/<split>/*.jpg + root/<alpha_dir>/<split>/<image>/*.png, and
optional guidance masks root/<mask_dir>/<split>/<image>/*.png.

Emits numpy sample dicts: image (1, H, W, 3) normalized float32; mask
(1, n_i, h', w') in [0,1]; alpha (1, n_i, H0, W0) in [0,1] at the original
size; trimap; image_names; alpha_names; transform_info; skip. With
``device_preprocess`` (and a mask dir), image and mask are tensors on
``device`` (``data/device_pipeline.py``).
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from . import imgproc
from . import transforms as T
from .utils import gen_transition_gt


class HIMDataset:
    def __init__(self, root_dir, split, max_inst=10, short_size=768, is_train=False,
                 random_seed=2023, downscale_mask=True, alpha_dir_name="alphas",
                 mask_dir_name="", device_preprocess=False,
                 decode: Callable[[str, str], np.ndarray] | None = None,
                 device=None, **kwargs):
        if is_train:
            raise NotImplementedError(
                "HIMDataset(is_train=True) is not ported yet: the train augmentations "
                "come with training, ROADMAP.md queue 1 item 10")
        self.root_dir = root_dir
        self.split = split
        self.alpha_dir_name = alpha_dir_name
        self.mask_dir_name = mask_dir_name
        self.short_size = short_size
        self.max_inst = max_inst
        self.downscale_mask = downscale_mask
        # the device tail needs guidance masks from a mask dir, as in the JAX package
        self.device_preprocess = bool(device_preprocess and mask_dir_name)
        self.device = device
        self.random = np.random.RandomState(random_seed)
        self._index()

        self.load = T.Load(decode=decode)
        tf = [self.load, T.ResizeShort(short_size), T.PaddingMultiplyBy(64), T.Stack()]
        if self.mask_dir_name == "":
            tf += [T.GenMaskFromAlpha(), T.DownUpMask(self.random, 0.125, 1.0)]
        tf += [T.ToNumpy(), T.Normalize()]
        self.transforms = T.Compose(tf)

    def _index(self):
        """root/images/<split>/*.jpg + root/<alpha_dir>/<split>/<image>/ (the
        reference's ``prepare_image_train``, him.py:67-80, indexes the EVAL
        layout: its helper names are swapped relative to use)."""
        images = sorted(glob.glob(os.path.join(self.root_dir, "images", self.split, "*.jpg")))
        data = []
        target = self.alpha_dir_name if self.mask_dir_name == "" else self.mask_dir_name
        for image in images:
            name = os.path.basename(image).replace(".jpg", "")
            adir = os.path.join(self.root_dir, target, self.split, name)
            if not os.path.isdir(adir):
                continue
            alphas = sorted(os.listdir(adir))
            data.append((image, [os.path.join(self.root_dir, self.alpha_dir_name, self.split,
                                              name, p) for p in alphas]))
        self.data = data

    def __len__(self):
        return len(self.data)

    @staticmethod
    def _trimap(alpha: np.ndarray) -> np.ndarray:
        """The metrics' trimap of (1, n_i, H0, W0) alphas in [0,1]: 2 where
        alpha > 0.5, 1 on the transition band, else 0."""
        trans = gen_transition_gt(alpha[0, :, None])[:, 0][None]
        trimap = np.zeros_like(alpha)
        trimap[alpha > 0.5] = 2.0
        trimap[trans > 0] = 1.0
        return trimap

    def _getitem_device(self, image_path, alpha_paths, mask_paths):
        """Eval sample with the device preprocessing tail: the host decodes and
        builds the metric-side alpha and trimap, which stay on the exact host path."""
        from .device_pipeline import device_preprocess_eval
        decode = self.load.decode
        masks = np.stack([decode(p, "L") for p in mask_paths])
        image, mask, transform_info = device_preprocess_eval(
            decode(image_path, "RGB"), masks, self.short_size, 64, self.downscale_mask,
            device=self.device)
        alpha = np.stack([decode(p, "L") for p in alpha_paths])[None].astype(np.float32) / 255.0
        trimap = self._trimap(alpha)
        return {
            "image": image, "mask": mask, "alpha": alpha, "trimap": trimap,
            "image_names": [image_path],
            "alpha_names": [os.path.basename(a) for a in alpha_paths],
            "transform_info": transform_info, "skip": 0,
        }

    def __getitem__(self, index):
        image_path, alphas = self.data[index]
        if len(alphas) > self.max_inst:
            alphas = list(self.random.choice(alphas, self.max_inst, replace=False))

        masks = None
        if self.mask_dir_name != "":
            masks = [a.replace(self.alpha_dir_name, self.mask_dir_name) for a in alphas]

        if self.device_preprocess:
            return self._getitem_device(image_path, alphas, masks)

        out_d = self.transforms({"frames": [image_path], "alphas": list(alphas), "masks": masks})
        image = out_d["frames"]            # (1, H, W, 3)
        mask = out_d["masks"].astype(np.float32) / 255.0
        alpha = out_d["ori_alphas"].astype(np.float32) / 255.0

        if self.downscale_mask:
            h8, w8 = image.shape[1] // 8, image.shape[2] // 8
            mask = np.stack([np.stack([imgproc.resize_nearest(m, (w8, h8)) for m in inst])
                             for inst in mask])

        trimap = self._trimap(alpha)
        return {
            "image": image, "mask": mask.astype(np.float32), "alpha": alpha,
            "trimap": trimap, "image_names": [image_path],
            "alpha_names": [os.path.basename(a) for a in alphas],
            "transform_info": out_d["transform_info"], "skip": 0,
        }
