"""M-HIM2K guidance-mask generation (port of ``tools/gen_mask/gen_mask.py``).

For every HIM2K image it writes one binary guidance mask per instance at
``<root>/masks_<name>/<subset>/<image>/%02d.png``, the layout that
``data/him.py`` reads with ``dataset.test.mask_dir_name masks_<name>``.

Backends:

- ``alpha`` (default, offline): each instance alpha binarized at 127, then
  degraded by its variant: a down-up linear resample (``DownUpMask``) and/or
  the boundary walk (``data/transforms.py::ModifyMaskBoundary``). Masks under
  2% of the image are dropped, as the detectron2 script drops them. Host
  work only (numpy, PIL for the files); the masks equal the JAX tool's.
- ``onnx``: a MaskRCNN-10 ONNX detector; the port has neither onnxruntime
  nor the model file, so it raises with the recipe.
- ``detectron2``: needs detectron2 and COCO weights; exits with the JAX
  tool's message.

Usage:
  python -m maggie_tpu_torch.tools.gen_mask --root data/HIM2K \\
      --subsets natural comp --variant perturb --name r50_c4_3x_sim --seed 0
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ..data import imgproc
from ..data.transforms import ModifyMaskBoundary, pil_decode

# Degradation recipes emulating detector families of decreasing quality:
# ratio = DownUpMask down-up factor (1.0 = off), perturb = boundary walk on/off.
VARIANTS = {
    "clean": dict(ratio=1.0, perturb=False),     # GenMaskFromAlpha only
    "downup": dict(ratio=0.125, perturb=False),  # os8-quality masks (the train-time corruption)
    "perturb": dict(ratio=1.0, perturb=True),    # boundary-walk only
    "full": dict(ratio=0.25, perturb=True),      # both: the weakest-detector stand-in
}

MIN_AREA_RATIO = 0.02  # the detectron2 script's area filter
MIN_SCORE_NOTE = 0.7   # a detector backend keeps person masks with score > 0.7

DETECTRON2_MESSAGE = (
    "The detectron2 backend needs the detectron2 package and COCO MaskRCNN "
    "weights (neither installable offline). Run the recipe in "
    "tools/gen_mask/README.md inside a detectron2 checkout; the output layout "
    "it produces is identical to this tool's. For a real detector that "
    "works with one pip install + one file, use --backend onnx.")


def _degrade(mask: np.ndarray, ratio: float, perturb: bool, rs: np.random.RandomState) -> np.ndarray:
    if ratio < 1.0:
        h, w = mask.shape[:2]
        small = imgproc.resize_scale(mask, ratio)
        mask = imgproc.resize_linear(small, (w, h))
        mask = (mask > 127).astype(np.uint8) * 255
    if perturb:
        mod = ModifyMaskBoundary(rs, p=0.0)  # p is the KEEP-unchanged probability
        mask = mod._modify(mask)
        mask = (mask > 127).astype(np.uint8) * 255
    return mask


def _save_png(mask: np.ndarray, path: str) -> None:
    from PIL import Image
    Image.fromarray(mask).save(path)


def gen_alpha_backend(root: str, subsets: list[str], name: str, variant: str,
                      alpha_dir: str = "alphas", seed: int = 0) -> int:
    """Write the masks of every image of ``subsets``; returns how many."""
    spec = VARIANTS[variant]
    rs = np.random.RandomState(seed)
    n_written = 0
    for subset in subsets:
        images = sorted(glob.glob(os.path.join(root, "images", subset, "*.jpg")))
        if not images:  # also accept the reference's flat layout images/<subset>/*.png
            images = sorted(glob.glob(os.path.join(root, "images", subset, "*.png")))
        for image in images:
            base = os.path.splitext(os.path.basename(image))[0]
            adir = os.path.join(root, alpha_dir, subset, base)
            alphas = sorted(glob.glob(os.path.join(adir, "*.png")))
            if not alphas:
                continue
            odir = os.path.join(root, f"masks_{name}", subset, base)
            os.makedirs(odir, exist_ok=True)
            idx = 0
            for apath in alphas:
                try:
                    alpha = pil_decode(apath, "L")
                except OSError:   # an unreadable file, skipped as cv2.imread's None is
                    continue
                mask = (alpha > 127).astype(np.uint8) * 255
                mask = _degrade(mask, spec["ratio"], spec["perturb"], rs)
                h, w = mask.shape[:2]
                if (mask > 0).sum() / float(h * w) < MIN_AREA_RATIO:
                    continue  # same area filter as the detectron2 script
                _save_png(mask, os.path.join(odir, "%02d.png" % idx))
                idx += 1
                n_written += 1
    return n_written


def main(argv: list[str] | None = None) -> int:
    """Run the CLI; returns the number of masks written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--root", required=True, help="HIM2K root (images/<subset>/, alphas/<subset>/)")
    ap.add_argument("--subsets", nargs="+", default=["natural", "comp"])
    ap.add_argument("--name", required=True, help="output suffix: masks_<name>/")
    ap.add_argument("--variant", default="perturb", choices=sorted(VARIANTS))
    ap.add_argument("--backend", default="alpha",
                    choices=["alpha", "onnx", "detectron2"])
    ap.add_argument("--alpha-dir", default="alphas")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.backend == "detectron2":
        raise SystemExit(DETECTRON2_MESSAGE)
    if args.backend == "onnx":
        from ..demo.segmenters import MaskRCNNOnnxSegmenter
        MaskRCNNOnnxSegmenter(score_threshold=MIN_SCORE_NOTE)   # raises with its recipe

    t0 = time.perf_counter()
    n = gen_alpha_backend(args.root, args.subsets, args.name, args.variant,
                          args.alpha_dir, args.seed)
    print(f"wrote {n} masks under {args.root}/masks_{args.name}/ in "
          f"{time.perf_counter() - t0:.3f} s")
    return n


if __name__ == "__main__":
    main()
