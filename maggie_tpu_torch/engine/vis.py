"""Training visualization (port of ``maggie_tpu/engine/vis.py``; reference
``wandb_log_image``, ``engine/train.py:26-78``).

Writes a panel PNG per ``vis_iter``: input image | guidance mask | GT alpha |
predicted alpha | transition, one row per instance slot (the first
``max_inst``) and frame of the batch's first sample, under
``<output_dir>/vis/``: a clip (a video batch) gives rows for each of its
frames (the JAX package shows frame 0 only). cv2's nearest resize is
``data/imgproc.py``'s, and PIL writes the file.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import imgproc
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _denorm(img: np.ndarray) -> np.ndarray:
    return np.clip((img * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255).astype(np.uint8)


def save_train_visualization(batch: dict, output: dict, it: int, out_dir: str,
                             max_inst: int = 4) -> str:
    """``batch``'s first sample and ``output``'s ``refined_masks`` (tensors or
    arrays, (b, n_f, n_i, ...)) as ``<out_dir>/vis/iter_<it>.png``; returns
    the path."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "vis"), exist_ok=True)
    images = _host(batch["image"])[0]                         # (n_f, H, W, 3)
    h, w = images.shape[1:3]

    def gray(m):
        m = np.asarray(m, np.float32)
        if m.shape != (h, w):
            m = imgproc.resize_nearest(m, (w, h))
        return np.repeat((np.clip(m, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)

    alphas = _host(batch["alpha"])[0] if "alpha" in batch else None
    masks = _host(batch["mask"])[0]
    preds = _host(output["refined_masks"])[0]
    trans = _host(batch["transition"])[0] if "transition" in batch else None
    rows = []
    for t in range(preds.shape[0]):
        img = _denorm(images[t])
        for i in range(min(preds.shape[1], max_inst)):
            panels = [img, gray(masks[t, i])]
            if alphas is not None:
                panels.append(gray(alphas[t, i]))
            panels.append(gray(preds[t, i]))
            if trans is not None:
                panels.append(gray(trans[t, i]))
            rows.append(np.concatenate(panels, axis=1))
    path = os.path.join(out_dir, "vis", f"iter_{it:07d}.png")
    Image.fromarray(np.concatenate(rows, axis=0)).save(path)
    return path
