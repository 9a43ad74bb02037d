"""VIM video instance-matting dataset, eval branch (port of
``maggie_tpu/data/vim.py``; reference ``maggie/dataloader/vim.py``).

Layout: ``root/<split>/fgr/<video>/<frame>.jpg``, the alphas
``root/<split>/<alpha_dir>/<video>/<frame>/*.png`` and, with a mask dir, the
guidance masks under the same names in ``<mask_dir>``.

Clips slide over each video with ``clip_overlap`` frames in common (3 and 2 in
the video config): every start from 0 while ``start < frames - overlap``, in
steps of ``clip_length - overlap`` (``_load_frame_ids``). A clip's sample:
image (T, H, W, 3) normalized float32; mask (T, n_i, H, W) in [0, 1] at the
image's size (video eval does not downscale masks); alpha (T, n_i, H0, W0) at
the original size; trimap; image_names; transform_info; and the streaming
flags ``is_first`` (start 0), ``is_last`` (the clip reaches the last frame)
and ``skip`` (0 for the first clip, else the overlap: the frames the previous
clip already scored). With ``device_preprocess`` (and a mask dir) image and
mask are tensors on ``device`` (``data/device_pipeline.py``).

Train (``maggie_tpu/data/vim.py:48-72,133-236``): a clip starts at every
frame that has ``clip_length`` frames to go (an overlap of ``clip_length -
1``). A sample draws a span of ``clip_length`` times 1 to ``max_step_size``
frames from its start, picks ``clip_length`` of them in order (reversed half
the time), drops one instance 20% of the time, augments the stack
(``RandomCropByAlpha`` ... ``MaskDropout``), scatters the instances into
random slots of ``max_inst`` and makes the transition GT: the pixels within a
random ellipse dilation of an alpha change of more than 5 levels between
neighbouring frames, over all instances (all ones on frame 0). A clip whose
masks or alphas come out empty is replaced by a random one. image (T, h, w, 3) of the crop; mask, alpha and
transition (T, max_inst, h, w), the masks at full size.

The draws come in the JAX package's order from the set's ``RandomState``,
except two that the reference, and so the JAX package, takes from numpy's
GLOBAL generator: the frames of the clip (``np.random.choice``) and the
dilation's iterations (``np.random.randint``). A sample therefore equals the
JAX package's when both start from the same ``RandomState`` and global
states, and leaves both in the same state. Under the loader, samples are
made in its one producer thread, in index order, so a run's samples follow
from its seeds as long as nothing else draws from numpy's global generator
while it trains (nothing in the port's trainer does; ``main`` seeds it). As
in the JAX package, no more is promised: another thread drawing from the
global generator at the same time changes the clips.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Callable

import numpy as np

from . import transforms as T
from .utils import gen_diff_mask, gen_transition_gt

logger = logging.getLogger(__name__)


class VIMDataset:
    def __init__(self, root_dir, split, clip_length=3, clip_overlap=2,
                 max_inst=10, is_train=False, short_size=576, mask_dir_name="",
                 alpha_dir_name="pha", random_seed=2023, device_preprocess=False,
                 max_step_size=5, crop=(512, 512), padding_crop_p=0.1, flip_p=0.5,
                 gamma_p=0.3, motion_p=0.3, add_noise_p=0.3, jpeg_p=0.1, affine_p=0.1,
                 binarized_kernel=30, downscale_mask_p=0.5, cache_images=0.0,
                 decode: Callable[[str, str], np.ndarray] | None = None,
                 device=None, **kwargs):
        self.is_train = is_train
        self.max_step_size = max_step_size
        self.root_dir = os.path.join(root_dir, split)
        self.short_size = short_size
        self.clip_length = clip_length
        self.overlap = clip_overlap
        self.max_inst = max_inst
        self.mask_dir_name = mask_dir_name
        self.alpha_dir_name = alpha_dir_name
        self.device_preprocess = bool(device_preprocess and mask_dir_name and not is_train)
        self.device = device
        self.random = np.random.RandomState(random_seed)

        self.video_infos: dict[str, list[str]] = {}
        self.frame_ids: list[tuple[str, int]] = []
        self._load_frame_ids(clip_length - 1 if is_train else self.overlap)

        self.load = T.Load(decode=decode, cache_gb=float(cache_images))
        # eval reads only the original alphas, unless it makes the masks from them
        resize_alphas = is_train or self.mask_dir_name == ""
        tf = [self.load, T.ResizeShort(short_size, transform_alphas=resize_alphas),
              T.PaddingMultiplyBy(64, transform_alphas=resize_alphas), T.Stack()]
        if is_train:
            tf += [T.RandomCropByAlpha(crop, self.random, padding_prob=padding_crop_p),
                   T.RandomHorizontalFlip(self.random, flip_p),
                   T.GammaContrast(self.random, p=gamma_p),
                   T.MotionBlur(self.random, p=motion_p),
                   T.AdditiveGaussianNoise(self.random, p=add_noise_p),
                   T.JpegCompression(self.random, p=jpeg_p),
                   T.RandomAffine(self.random, p=affine_p),
                   T.GenMaskFromAlpha(),
                   T.RandomBinarizedMask(self.random, binarize_max_k=binarized_kernel),
                   T.DownUpMask(self.random, 0.125, downscale_mask_p),
                   T.CutMask(self.random),
                   T.MaskDropout(self.random)]
        elif self.mask_dir_name == "":
            tf += [T.GenMaskFromAlpha(), T.DownUpMask(self.random, 0.125, 1.0)]
        tf += [T.ToNumpy(), T.Normalize()]
        self.transforms = T.Compose(tf)

    def _load_frame_ids(self, overlap: int) -> None:
        fg_dir = os.path.join(self.root_dir, self.alpha_dir_name)
        for video_name in sorted(os.listdir(fg_dir)):
            frame_names = sorted(os.listdir(os.path.join(self.root_dir, "fgr", video_name)))
            self.video_infos[video_name] = frame_names
            start = 0
            upper = (len(frame_names) - self.clip_length + 1 if self.is_train
                     else len(frame_names) - overlap)
            while start < upper:
                self.frame_ids.append((video_name, start))
                start += self.clip_length - overlap

    def __len__(self):
        return len(self.frame_ids)

    def _flags(self, video_name: str, start: int) -> dict:
        return {"skip": 0 if start == 0 else self.overlap, "is_first": int(start == 0),
                "is_last": int(start + self.clip_length >= len(self.video_infos[video_name]))}

    @staticmethod
    def _trimap(alpha: np.ndarray) -> np.ndarray:
        """The metrics' trimap of (T, n_i, H0, W0) alphas in [0, 1]: 2 where
        alpha > 0.5, 1 on the transition band, else 0."""
        trans = gen_transition_gt(alpha.reshape((-1,) + alpha.shape[2:])[:, None])
        trimap = np.zeros_like(alpha)
        trimap[alpha > 0.5] = 2.0
        trimap[trans.reshape(alpha.shape) > 0] = 1.0
        return trimap

    def _getitem_device(self, video_name, start, frame_paths, alpha_paths, mask_paths):
        """The clip with the device preprocessing tail, frame by frame; the host
        decodes and builds the metric-side alpha and trimap."""
        import torch

        from .device_pipeline import device_preprocess_eval
        decode = self.load.decode
        n_f = len(frame_paths)
        n_i = len(alpha_paths) // n_f
        images, masks, info = [], [], None
        for t in range(n_f):
            m = np.stack([decode(p, "L") for p in mask_paths[t * n_i:(t + 1) * n_i]])
            im, mk, info = device_preprocess_eval(decode(frame_paths[t], "RGB"), m,
                                                  self.short_size, 64, downscale_mask=False,
                                                  device=self.device)
            images.append(im)
            masks.append(mk)
        alpha = np.stack([decode(p, "L") for p in alpha_paths]).astype(np.float32) / 255.0
        alpha = alpha.reshape((n_f, n_i) + alpha.shape[1:])
        return {"image": torch.cat(images), "mask": torch.cat(masks), "alpha": alpha,
                "trimap": self._trimap(alpha), "image_names": frame_paths,
                "transform_info": info, **self._flags(video_name, start)}

    def _paths(self, video_name: str, frame_names: list) -> tuple[list, list]:
        frame_paths = [os.path.join(self.root_dir, "fgr", video_name, f) for f in frame_names]
        alpha_paths = []
        for f in frame_names:
            paths = sorted(glob.glob(os.path.join(self.root_dir, self.alpha_dir_name,
                                                  video_name, f.replace(".jpg", ""), "*.png")))
            alpha_paths.extend(paths[:self.max_inst])
        return frame_paths, alpha_paths

    def _train_clip(self, idx: int) -> dict:
        """One augmented train clip (``maggie_tpu/data/vim.py:133-236``)."""
        video_name, start = self.frame_ids[idx]
        names = self.video_infos[video_name]
        end = min(start + self.clip_length * self.random.randint(1, self.max_step_size + 1),
                  len(names))
        chosen = sorted(np.random.choice(names[start:end], min(end - start, self.clip_length),
                                         replace=False))
        if self.random.rand() > 0.5:
            chosen = chosen[::-1]
        frame_paths, alpha_paths = self._paths(video_name, list(chosen))
        if self.random.rand() < 0.2:          # drop one instance of every frame
            n_inst = len(alpha_paths) // len(frame_paths)
            if n_inst > 1:
                drop = self.random.randint(0, n_inst)
                alpha_paths = [p for j, p in enumerate(alpha_paths) if j % n_inst != drop]

        d = self.transforms({"frames": frame_paths, "alphas": alpha_paths, "masks": None})
        frames, alphas, masks = d["frames"], d["alphas"], d["masks"]
        if masks.sum() == 0 or alphas.sum() == 0 or (masks.sum((1, 2, 3)) == 0).any():
            logger.error(f"Mask or alpha is zero: {idx}")
            return self[self.random.randint(0, len(self))]
        if self.max_inst > alphas.shape[1]:   # the instances into random slots
            na = np.zeros((alphas.shape[0], self.max_inst) + alphas.shape[2:], alphas.dtype)
            nm = np.zeros((masks.shape[0], self.max_inst) + masks.shape[2:], masks.dtype)
            ids = self.random.choice(self.max_inst, alphas.shape[1], replace=False)
            na[:, ids] = alphas
            nm[:, ids] = masks
            alphas, masks = na, nm

        # the transition GT: the dilated union over instances of the changes
        # (the union of the per-instance dilations the reference takes, as
        # the dilation is a max over in-map pixels)
        k_size = int(self.random.choice(range(2, 5)))
        iterations = int(np.random.randint(3, 7))
        changed = (np.abs(alphas[1:] - alphas[:-1]) > 5).any(axis=1)
        band = gen_diff_mask(changed[:, None].astype(np.uint8) * 255, k_size, iterations) > 0
        band = np.concatenate([np.ones_like(band[:1]), band], axis=0)   # (T, 1, h, w)
        transition = np.broadcast_to(band, alphas.shape).astype(np.float32)

        alphas = alphas.astype(np.float32) / 255.0
        masks = masks.astype(np.float32) / 255.0
        # a clip with no mask pixel left in any 8x8 block is replaced
        m = masks.reshape((-1,) + masks.shape[2:])
        h8, w8 = m.shape[1] // 8 * 8, m.shape[2] // 8 * 8
        if m[:, :h8, :w8].reshape(m.shape[0], h8 // 8, 8, w8 // 8, 8).max((2, 4)).sum() == 0:
            logger.error(f"Small masks is zero: {idx}")
            return self[self.random.randint(0, len(self))]
        return {"image": frames, "mask": masks, "alpha": alphas, "transition": transition}

    def __getitem__(self, idx):
        if self.is_train:
            return self._train_clip(idx)
        video_name, start = self.frame_ids[idx]
        frame_names = self.video_infos[video_name][start:start + self.clip_length]
        frame_paths, alpha_paths = self._paths(video_name, frame_names)
        mask_paths = None
        if self.mask_dir_name != "":
            mask_paths = [p.replace(f"/{self.alpha_dir_name}/", f"/{self.mask_dir_name}/")
                          for p in alpha_paths]
        if self.device_preprocess:
            return self._getitem_device(video_name, start, frame_paths, alpha_paths, mask_paths)

        d = self.transforms({"frames": frame_paths, "alphas": alpha_paths, "masks": mask_paths})
        alpha = d["ori_alphas"].astype(np.float32) / 255.0
        return {"image": d["frames"], "mask": d["masks"].astype(np.float32) / 255.0,
                "alpha": alpha, "trimap": self._trimap(alpha), "image_names": frame_paths,
                "transform_info": d["transform_info"], **self._flags(video_name, start)}
