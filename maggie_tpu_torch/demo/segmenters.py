"""Instance-mask segmenters feeding the demo (port of ``demo/segmenters.py``;
reference ``demo/maskrcnn.py``, ``demo/xmem_processor.py``,
``demo/samurai_processor.py``).

- ``MaskFileSegmenter``: masks the user already has (what the external
  models would produce).
- ``FlowPropagator``: the first frame's label map carried to every frame by
  Farneback flow, without cv2: ``ops/optical_flow.py::farneback_flow`` at
  the propagator's setting, cv2's fixed-point ``COLOR_RGB2GRAY``, a nearest
  ``remap`` with a zero border and a ``MORPH_CLOSE`` with the 5x5 ellipse
  (``ops/morphology.py``'s runs).
- ``MaskRCNNOnnxSegmenter``, ``XMemPropagator``, ``Sam2Propagator``: they
  need weights and packages from outside, and the port runs none of them:
  each raises with the JAX package's recipe.
"""

from __future__ import annotations

import numpy as np

from ..ops.morphology import ellipse_sum_runs, grey_dilate_runs, grey_erode_runs
from ..ops.optical_flow import farneback_flow


def label_map_to_instances(label_map: np.ndarray) -> list[np.ndarray]:
    """0/255 binary mask per instance id, the MaGGIe guidance format
    (reference ``demo/maggie_predictor.py:36-44``)."""
    ids = np.unique(label_map)
    return [((label_map == i) * 255).astype(np.uint8) for i in ids if i != 0]


def _overlay(image, label_map: np.ndarray):
    """The image with each instance blended half and half with a colour drawn
    from ``RandomState(0)``."""
    from PIL import Image
    rs = np.random.RandomState(0)
    img = np.array(image.convert("RGB")).astype(np.float32)
    for i in np.unique(label_map):
        if i == 0:
            continue
        color = rs.randint(64, 255, 3).astype(np.float32)
        m = (label_map == i)[..., None]
        img = np.where(m, 0.5 * img + 0.5 * color, img)
    return Image.fromarray(img.astype(np.uint8))


class MaskFileSegmenter:
    """Masks from files: one label-map PNG, or one binary PNG per instance."""

    def __init__(self, mask_paths: list[str]):
        self.mask_paths = mask_paths

    def segment(self, image):
        """Returns (visualization, label_map): label_map HxW uint8 with 0 the
        background and 1..n the instances."""
        from PIL import Image
        arrs = [np.array(Image.open(p).convert("L")) for p in self.mask_paths]
        if len(arrs) == 1 and len(np.unique(arrs[0])) > 2:
            label_map = arrs[0]
        else:
            label_map = np.zeros_like(arrs[0])
            for i, a in enumerate(arrs):
                label_map[a > 127] = i + 1
        return _overlay(image, label_map), label_map


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)`` of a uint8 (H, W, 3) image:
    cv2's 15-bit fixed point, (9798 R + 19235 G + 3735 B + 2^14) >> 15."""
    x = rgb.astype(np.int32)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, INTER_NEAREST, borderMode=BORDER_CONSTANT,
    borderValue=0)`` with float32 maps: each output pixel takes the source
    pixel at the rounded (half to even) coordinates, 0 outside the map."""
    h, w = src.shape[:2]
    x = np.rint(map_x)
    y = np.rint(map_y)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xi = np.where(inside, x, 0).astype(np.int64)
    yi = np.where(inside, y, 0).astype(np.int64)
    return np.where(inside, src[yi, xi], 0).astype(src.dtype)


def morph_close_ellipse(x: np.ndarray, width: int = 5) -> np.ndarray:
    """``cv2.morphologyEx(x, MORPH_CLOSE, getStructuringElement(MORPH_ELLIPSE,
    (width, width)))``: dilation, then erosion, pixels outside the map
    ignored by both."""
    runs = ellipse_sum_runs(width)
    return grey_erode_runs(grey_dilate_runs(x, runs), runs)


class FlowPropagator:
    """Video mask propagation by Farneback dense optical flow (no learned
    weights): the first frame's label map is warped forward frame by frame by
    backward sampling and a nearest remap, and each warped map is closed by a
    5x5 ellipse. It fills the role XMem and SAM2 play in the reference demo
    (``demo/app.py:35-43``); accuracy is what classical flow gives."""

    def __init__(self, pyr_scale: float = 0.5, levels: int = 4,
                 winsize: int = 21, iterations: int = 5):
        self.params = dict(pyr_scale=pyr_scale, levels=levels, winsize=winsize,
                           iterations=iterations, poly_n=5, poly_sigma=1.1, flags=0)

    def propagate(self, frames, first_mask: np.ndarray) -> list[np.ndarray]:
        """The label map of every frame (uint8 (H, W)), the first one's given."""
        grays = [rgb_to_gray(np.array(f.convert("RGB"))) for f in frames]
        h, w = grays[0].shape
        gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        out = [first_mask.astype(np.uint8)]
        for t in range(1, len(grays)):
            # flow from frame t back to t-1: where each pixel came from, so
            # one nearest remap pulls the labels
            flow = farneback_flow(grays[t], grays[t - 1], **self.params)
            warped = remap_nearest(out[-1], gx + flow[..., 0], gy + flow[..., 1])
            out.append(morph_close_ellipse(warped, 5))   # close pinholes the flow opens
        return out


class MaskRCNNOnnxSegmenter:
    """MaskRCNN-10 ONNX human-instance proposals (``demo/maskrcnn.py``): not
    run by the port, which has no onnxruntime and no model file; raises with
    the recipe."""

    MODEL = "MaskRCNN-10.onnx"
    RECIPE = (
        "MaskRCNN backend needs: (1) `pip install onnxruntime`; (2) the model "
        "file MaskRCNN-10.onnx next to demo/app.py — "
        "https://github.com/onnx/models/tree/main/validated/vision/"
        "object_detection_segmentation/mask-rcnn (the reference wgets the same "
        "file, demo/maskrcnn.py:41-42). Then re-run."
    )

    def __init__(self, model_path: str | None = None, score_threshold: float = 0.7):
        raise RuntimeError(self.RECIPE)


class _ExternalPropagator:
    """A learned propagator that runs in its upstream repo's own environment
    (``demo/segmenters.py::_SubprocessPropagator``); the port runs none:
    raises with the recipe."""

    RECIPE = ""

    def __init__(self, repo_dir: str | None = None, weights: str | None = None):
        raise RuntimeError(self.RECIPE)


class XMemPropagator(_ExternalPropagator):
    RECIPE = (
        "XMem propagation needs the upstream repo + checkpoint: "
        "`git clone https://github.com/hkchengrex/XMem` and XMem.pth "
        "(https://github.com/hkchengrex/XMem/releases/download/v1.0/XMem.pth — "
        "the reference wgets the same file, demo/xmem_processor.py:18-19). "
        "Point XMEM_DIR at the checkout, XMEM_WEIGHTS at the .pth (and "
        "XMEM_PYTHON at its venv's python if separate), then re-run. "
        "Alternatively feed externally-produced masks via MaskFileSegmenter / "
        "the mask-directory input."
    )


class Sam2Propagator(_ExternalPropagator):
    RECIPE = (
        "SAM2/Samurai propagation needs the upstream sam2 (or samurai) "
        "package + checkpoint (the reference vendors a patched sam2_base.py "
        "and runs demo/samurai_processor.py, demo/app.py:40-43). Point "
        "SAM2_DIR at the repo (the dir containing the `sam2` package), "
        "SAM2_WEIGHTS at the checkpoint, and SAM2_PYTHON at its venv's python "
        "if separate, then re-run. Alternatively feed externally-produced "
        "masks via MaskFileSegmenter / the mask-directory input."
    )
