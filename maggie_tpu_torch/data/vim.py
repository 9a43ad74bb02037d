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
mask are tensors on ``device`` (``data/device_pipeline.py``). Training on VIM
(the clip sampler and the video augmentations) is ROADMAP item 11b.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from . import transforms as T
from .utils import gen_transition_gt


class VIMDataset:
    def __init__(self, root_dir, split, clip_length=3, clip_overlap=2,
                 max_inst=10, is_train=False, short_size=576, mask_dir_name="",
                 alpha_dir_name="pha", random_seed=2023, device_preprocess=False,
                 decode: Callable[[str, str], np.ndarray] | None = None,
                 device=None, **kwargs):
        if is_train:
            raise NotImplementedError("training on VIM is not ported yet: the video clip "
                                      "sampler and augmentations are ROADMAP.md queue 1 "
                                      "item 11b")
        self.root_dir = os.path.join(root_dir, split)
        self.short_size = short_size
        self.clip_length = clip_length
        self.overlap = clip_overlap
        self.max_inst = max_inst
        self.mask_dir_name = mask_dir_name
        self.alpha_dir_name = alpha_dir_name
        self.device_preprocess = bool(device_preprocess and mask_dir_name)
        self.device = device
        self.random = np.random.RandomState(random_seed)

        self.video_infos: dict[str, list[str]] = {}
        self.frame_ids: list[tuple[str, int]] = []
        self._load_frame_ids(self.overlap)

        self.load = T.Load(decode=decode)
        # eval reads only the original alphas, unless it makes the masks from them
        resize_alphas = self.mask_dir_name == ""
        tf = [self.load, T.ResizeShort(short_size, transform_alphas=resize_alphas),
              T.PaddingMultiplyBy(64, transform_alphas=resize_alphas), T.Stack()]
        if self.mask_dir_name == "":
            tf += [T.GenMaskFromAlpha(), T.DownUpMask(self.random, 0.125, 1.0)]
        tf += [T.ToNumpy(), T.Normalize()]
        self.transforms = T.Compose(tf)

    def _load_frame_ids(self, overlap: int) -> None:
        fg_dir = os.path.join(self.root_dir, self.alpha_dir_name)
        for video_name in sorted(os.listdir(fg_dir)):
            frame_names = sorted(os.listdir(os.path.join(self.root_dir, "fgr", video_name)))
            self.video_infos[video_name] = frame_names
            start = 0
            while start < len(frame_names) - overlap:
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

    def __getitem__(self, idx):
        video_name, start = self.frame_ids[idx]
        frame_names = self.video_infos[video_name][start:start + self.clip_length]
        frame_paths = [os.path.join(self.root_dir, "fgr", video_name, f) for f in frame_names]
        alpha_paths = []
        for f in frame_names:
            paths = sorted(glob.glob(os.path.join(self.root_dir, self.alpha_dir_name,
                                                  video_name, f.replace(".jpg", ""), "*.png")))
            alpha_paths.extend(paths[:self.max_inst])
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
