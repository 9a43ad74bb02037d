"""HIM image instance-matting dataset (port of ``maggie_tpu/data/him.py``;
reference ``maggie/dataloader/him.py``).

Directory contract (reference ``docs/DATASET.md:68-107``):
- train: root/<split>/images/*.jpg + root/<split>/<alpha_dir>/<image>/*.png;
- eval: root/images/<split>/*.jpg + root/<alpha_dir>/<split>/<image>/*.png, and
  optional guidance masks root/<mask_dir>/<split>/<image>/*.png.

Emits numpy sample dicts. Eval: image (1, H, W, 3) normalized float32; mask
(1, n_i, h', w') in [0,1]; alpha (1, n_i, H0, W0) in [0,1] at the original
size; trimap; image_names; alpha_names; transform_info; skip. With
``device_preprocess`` (and a mask dir), image and mask are tensors on
``device`` (``data/device_pipeline.py``). Train: image (1, h, w, 3) of the
crop; mask (1, max_inst, h/8, w/8) and alpha and transition (1, max_inst, h, w),
the instances in random slots. Every random draw of a train sample comes from
the dataset's ``RandomState(random_seed)``, in the JAX package's order.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Callable

import numpy as np

from . import imgproc
from . import transforms as T
from .utils import gen_transition_gt

logger = logging.getLogger(__name__)


class HIMDataset:
    def __init__(self, root_dir, split, max_inst=10, short_size=768, is_train=False,
                 random_seed=2023, crop=(512, 512), padding_crop_p=0.1, flip_p=0.5,
                 gamma_p=0.3, add_noise_p=0.3, jpeg_p=0.1, affine_p=0.1,
                 binarized_kernel=30, downscale_mask_p=0.5, downscale_mask=True,
                 alpha_dir_name="alphas", mask_dir_name="", device_preprocess=False,
                 cache_images=0.0,
                 decode: Callable[[str, str], np.ndarray] | None = None,
                 device=None, **kwargs):
        self.root_dir = root_dir
        self.split = split
        self.alpha_dir_name = alpha_dir_name
        self.mask_dir_name = mask_dir_name
        self.is_train = is_train
        self.short_size = short_size
        self.max_inst = max_inst
        # train: the reference couples this to downscale_mask_p (him.py:27)
        self.downscale_mask = (downscale_mask_p > 0) if is_train else downscale_mask
        # the device tail needs guidance masks from a mask dir, as in the JAX package
        self.device_preprocess = bool(device_preprocess and mask_dir_name and not is_train)
        self.device = device
        self.random = np.random.RandomState(random_seed)
        if is_train:
            self._index_split_first()
        else:
            self._index()

        self.load = T.Load(decode=decode, cache_gb=float(cache_images))
        # eval reads only the original alphas, unless it derives masks from them
        resize_alphas = is_train or self.mask_dir_name == ""
        tf = [self.load, T.ResizeShort(short_size, transform_alphas=resize_alphas),
              T.PaddingMultiplyBy(64, transform_alphas=resize_alphas), T.Stack()]
        if is_train:
            tf += [
                T.RandomCropByAlpha(crop, self.random, padding_prob=padding_crop_p),
                T.RandomHorizontalFlip(self.random, flip_p),
                T.GammaContrast(self.random, p=gamma_p),
                T.AdditiveGaussianNoise(self.random, p=add_noise_p),
                T.JpegCompression(self.random, p=jpeg_p),
                T.RandomAffine(self.random, p=affine_p),
                T.RandomBinarizedMask(self.random, binarized_kernel),
                T.DownUpMask(self.random, 0.125, downscale_mask_p),
                T.CutMask(self.random),
            ]
        elif self.mask_dir_name == "":
            tf += [T.GenMaskFromAlpha(), T.DownUpMask(self.random, 0.125, 1.0)]
        tf += [T.ToNumpy(), T.Normalize()]
        self.transforms = T.Compose(tf)

    def _index_split_first(self):
        """root/<split>/images/*.jpg + root/<split>/<alpha_dir>/<image>/*.png, the
        TRAIN layout (the reference's ``prepare_image_test``, him.py:82-89)."""
        images = sorted(glob.glob(os.path.join(self.root_dir, self.split, "images", "*.jpg")))
        self.data = [(image, sorted(glob.glob(os.path.join(
            self.root_dir, self.split, self.alpha_dir_name,
            os.path.basename(image).replace(".jpg", ""), "*.png")))) for image in images]

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
        if self.is_train:
            return self._train_sample(image_path, alphas)

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

    def _train_sample(self, image_path, alphas):
        """One augmented crop (``maggie_tpu/data/him.py:138-208``); the masks
        are the alphas, corrupted by the augmentations."""
        out_d = self.transforms({"frames": [image_path], "alphas": list(alphas),
                                 "masks": list(alphas)})
        image = out_d["frames"]            # (1, h, w, 3)
        alpha = out_d["alphas"]            # (1, n_i, h, w) 0..255
        mask = out_d["masks"]              # (1, n_i, h, w) 0..255 uint8

        # drop tiny instances (< 0.1% area, reference him.py:120-135)
        valid = (alpha > 127).sum((-1, -2)) > (0.001 * alpha.shape[-1] * alpha.shape[-2])
        keep = np.nonzero(valid[0])[0]
        if len(keep) == 0:
            logger.warning("Mask empty after removing tiny instances; resampling")
            return self[self.random.randint(0, len(self.data))]
        alpha, mask = alpha[:, keep], mask[:, keep]

        # random instance drop 5% (him.py:138-149)
        if alpha.shape[1] > 1 and self.random.rand() < 0.05:
            ids = self.random.choice(alpha.shape[1], alpha.shape[1] - 1, replace=False)
            alpha, mask = alpha[:, ids], mask[:, ids]

        if mask.sum() == 0:
            logger.warning("Mask is empty; resampling")
            return self[self.random.randint(0, len(self.data))]

        alpha = alpha.astype(np.float32) / 255.0
        mask = mask.astype(np.float32) / 255.0
        if self.max_inst - alpha.shape[1] > 0:
            # scatter the instances into random slots of max_inst (him.py:159-174)
            new_alpha = np.zeros((1, self.max_inst, *alpha.shape[2:]), np.float32)
            new_mask = np.zeros((1, self.max_inst, *mask.shape[2:]), np.float32)
            ids = self.random.choice(self.max_inst, alpha.shape[1], replace=False)
            new_alpha[:, ids] = alpha
            new_mask[:, ids] = mask
            alpha, mask = new_alpha, new_mask

        if self.downscale_mask:
            h8, w8 = image.shape[1] // 8, image.shape[2] // 8
            mask = np.stack([np.stack([imgproc.resize_nearest(m, (w8, h8)) for m in inst])
                             for inst in mask])

        k_size = int(self.random.choice(range(2, 5)))
        iterations = int(self.random.randint(5, 15))
        trans = gen_transition_gt(alpha[0, :, None], mask[0, :, None],
                                  k_size=k_size, iterations=iterations)
        return {"image": image, "mask": mask.astype(np.float32),
                "alpha": alpha.astype(np.float32),
                "transition": trans[None, :, 0].astype(np.float32)}
