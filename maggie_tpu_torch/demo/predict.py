"""Inference demo on the port: image or video instance matting from files
(port of ``demo/predict.py``).

The guidance masks are inputs, what the external segmenters would produce;
the model runs on the card unless ``--device cpu`` is given (without a GPU
and without ``--device cpu`` it raises).

Usage:
  # image: one RGB + one binary PNG per instance
  python -m maggie_tpu_torch.demo.predict image --weights w.safetensors \\
      --image img.jpg --masks m0.png m1.png --out out_dir
  # video: frame directory + per-frame mask directories (inst-indexed PNGs)
  python -m maggie_tpu_torch.demo.predict video --weights w.safetensors \\
      --frames frames_dir --masks masks_dir --out out_dir [--device cpu]

``--weights`` takes what ``utils/checkpoint.py::load_model_weights`` reads: a
torch ``.pth``/``.bin``, a ``.safetensors``, a snapshot dir or a JAX-package
``.npz``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data import transforms as T
from ..utils.postprocess import reverse_transform

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAME_TF = T.Compose([
    T.ResizeShort(576, transform_alphas=False),
    T.PaddingMultiplyBy(64, transform_alphas=False),
    T.Stack(),
    T.ToNumpy(),
    T.Normalize(),
])


def preprocess(frames, inst_masks: list[list[np.ndarray]], device=None):
    """frames: PIL images; inst_masks: per frame, a list of HxW uint8 masks.
    Returns the model's batch on ``device`` (CPU tensors when None) and the
    transform info that ``reverse_transform`` undoes."""
    flat_masks = [m for per_frame in inst_masks for m in per_frame]
    d = {
        "frames": [np.array(f.convert("RGB")) for f in frames],
        "alphas": list(flat_masks),
        "masks": list(flat_masks),
        "transform_info": [],
    }
    for t in FRAME_TF.transforms:   # no Load: the frames are arrays already
        d = t(d)
    batch = {
        "image": torch.from_numpy(np.ascontiguousarray(d["frames"][None])),
        "mask": torch.from_numpy(d["masks"][None].astype(np.float32) / 255.0),
    }
    if device is not None:
        batch = {k: v.to(device) for k, v in batch.items()}
    return batch, d["transform_info"]


def _config_path(path: str) -> str:
    return path if os.path.isabs(path) or os.path.exists(path) else os.path.join(_REPO_ROOT, path)


def build(cfg_path, weights: str, video: bool, device=None):
    """The model of ``cfg_path`` (a config file's path, or a ``ConfigNode``)
    with ``weights`` loaded, spectral norm folded, in eval mode on ``device``
    (CUDA unless the caller passes "cpu"; raises without a GPU)."""
    from ..config import ConfigNode, load_config
    from ..device import resolve_device
    from ..models import build_model
    from ..utils.checkpoint import fold_spectral_norm, load_model_weights
    dev = resolve_device(device)
    cfg = (cfg_path.clone() if isinstance(cfg_path, ConfigNode)
           else load_config(_config_path(cfg_path)))
    cfg.model.weights = weights
    model = load_model_weights(build_model(cfg.model, device="cpu"), cfg)
    return fold_spectral_norm(model).to(dev).eval()


def matte(model, frames, inst_masks, prev_pred=None):
    """One forward on ``frames`` and their masks: ``(alpha, refined)``, the
    clamped alphas (1, n_f, n_i, H, W) at the frames' size on the host and the
    model's ``refined_masks`` on its device (the next window's
    ``prev_pred``)."""
    batch, tinfo = preprocess(frames, inst_masks, next(model.parameters()).device)
    with torch.inference_mode():
        out = model(batch) if prev_pred is None else model(batch, prev_pred=prev_pred)
    refined = out["refined_masks"]
    alpha = reverse_transform(refined.float().cpu().numpy(), tinfo)
    alpha[alpha <= 1 / 255] = 0.0
    alpha[alpha >= 254 / 255] = 1.0
    return alpha, refined


def video_windows(model, n_frames: int, frame_at, masks_at):
    """Streams the video model over ``n_frames`` frames in 3-frame windows
    with overlap 2, the whole forward on each, the previous window's middle
    ``refined_masks`` carried as ``prev_pred``. ``frame_at(t)`` and
    ``masks_at(t)`` give frame t (a PIL image) and its instance masks. A
    video shorter than a window is padded by repeating its last frame.
    Yields ``(start, frames, alpha, keep)`` a window: its first frame's
    index, its 3 frames, their alphas (1, 3, n_i, H, W) and the positions
    whose mattes are final (the first; every real frame in the last
    window)."""
    prev_pred = None
    last = max(n_frames - 3, 0)
    for start in range(0, max(n_frames - 2, 1)):
        idx = range(start, min(start + 3, n_frames))
        frames = [frame_at(t) for t in idx]
        inst = [masks_at(t) for t in idx]
        while len(frames) < 3:
            frames.append(frames[-1])
            inst.append(inst[-1])
        alpha, refined = matte(model, frames, inst, prev_pred)
        prev_pred = refined[:, 1]
        yield start, frames, alpha, (range(len(idx)) if start == last else [0])


def save_alphas(alpha: np.ndarray, out_dir: str, frame_names: list[str]):
    """One PNG per frame and instance: ``out_dir/<frame>/<inst:02d>.png``."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    for t in range(alpha.shape[1]):
        for i in range(alpha.shape[2]):
            d = os.path.join(out_dir, os.path.splitext(frame_names[t])[0])
            os.makedirs(d, exist_ok=True)
            Image.fromarray((alpha[0, t, i] * 255).astype(np.uint8)).save(
                os.path.join(d, f"{i:02d}.png"))


def _read_masks(mdir: str) -> list[np.ndarray]:
    """The instance masks of one frame: the dir's PNGs in name order, as L."""
    from PIL import Image
    return [np.array(Image.open(os.path.join(mdir, m)).convert("L")) for m in sorted(os.listdir(mdir))]


def main(argv=None):
    from PIL import Image
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["image", "video"])
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights", default="")
    ap.add_argument("--image", default=None)
    ap.add_argument("--frames", default=None)
    ap.add_argument("--masks", nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mode == "image":
        model = build(args.config or "configs/maggie_image.yaml", args.weights, video=False,
                      device=args.device)
        frame = Image.open(args.image)
        masks = [np.array(Image.open(m).convert("L")) for m in args.masks]
        alpha, _ = matte(model, [frame], [masks])
        save_alphas(alpha, args.out, [os.path.basename(args.image)])
        print(f"Wrote {alpha.shape[2]} instance mattes to {args.out}")
    else:
        model = build(args.config or "configs/maggie_video.yaml", args.weights, video=True,
                      device=args.device)
        frame_names = sorted(os.listdir(args.frames))
        mask_root = args.masks[0]
        os.makedirs(args.out, exist_ok=True)
        windows = video_windows(
            model, len(frame_names),
            lambda t: Image.open(os.path.join(args.frames, frame_names[t])),
            lambda t: _read_masks(os.path.join(mask_root, os.path.splitext(frame_names[t])[0])))
        for start, _, alpha, keep in windows:
            for t in keep:
                save_alphas(alpha[:, t:t + 1], args.out, [frame_names[start + t]])
        print(f"Wrote mattes to {args.out}")


if __name__ == "__main__":
    main()
