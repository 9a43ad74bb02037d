"""Eval ground-truth helpers (port of ``maggie_tpu/data/utils.py``; reference
``maggie/dataloader/utils.py``). cv2's ellipse dilation and erosion become the
port's own host versions (``ops/morphology.py``)."""

from __future__ import annotations

import numpy as np

from ..ops.morphology import grey_dilate_ellipse, grey_erode_ellipse


def gen_transition_gt(alphas: np.ndarray, masks: np.ndarray | None = None,
                      k_size: int = 25, iterations: int = 1) -> np.ndarray:
    """Transition band = (dilate - erode) > 0 with a cv2 ``MORPH_ELLIPSE``
    element, optionally OR'd with mask-alpha disagreement (reference
    ``utils.py:15-35``). alphas: (N, 1, H, W) float; returns (N, 1, H, W) f32.

    The disagreement clause compares ``alphas > 127`` and ``masks == 255`` on
    [0,1]-scaled inputs at the reference's call sites, so it never fires there;
    it is kept as the JAX package keeps it (``maggie_tpu/data/utils.py:31-40``).
    """
    out = []
    for x in alphas:
        m = x[0].astype(np.float32)
        if not m.any():  # padded empty instance slot: band is identically zero
            out.append(np.zeros_like(m))
            continue
        dilated = eroded = m
        for _ in range(iterations):
            dilated = grey_dilate_ellipse(dilated, k_size)
            eroded = grey_erode_ellipse(eroded, k_size)
        out.append(((dilated - eroded) > 0).astype(np.float32))
    trans = np.stack(out)[:, None]  # (N, 1, H, W)

    if masks is not None and ((masks == 255).any() or (alphas > 127).any()):
        if masks.shape[-1] != alphas.shape[-1]:
            masks = masks.repeat(8, axis=-1).repeat(8, axis=-2)
        diff = (alphas > 127) != (masks == 255)
        trans[diff > 0] = 1.0
    return trans
