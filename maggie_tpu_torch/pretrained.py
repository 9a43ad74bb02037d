"""One-call model loading, the reference's ``MaGGIe.from_pretrained`` surface
(port of ``maggie_tpu/pretrained.py``).

    model, cfg = maggie_tpu_torch.pretrained.from_pretrained(
        "weights/maggie_image.pth", config="configs/maggie_image.yaml")
    out = model(batch)   # on the card

``weights`` is a local torch ``.pth``/``.bin`` file or snapshot dir, or a JAX
package ``.npz`` (``utils/checkpoint.py``); spectral norm is folded for eval.
Nothing is downloaded, and model-zoo ids are not resolved: hub checkpoints are
not ported, so ``config`` is required and a hub id raises ``FileNotFoundError``."""

from __future__ import annotations

import os
from typing import Any

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def from_pretrained(weights: str, config: Any, overrides: dict | None = None,
                    device=None):
    """Returns ``(model, cfg)``: the model in eval mode on ``device`` (CUDA
    unless the caller passes "cpu"; raises without a GPU).

    ``config`` is a ``ConfigNode`` or a config file's path (relative paths also
    resolve against the repo root). ``overrides`` is a dict of dotted config
    overrides, e.g. ``from_pretrained(w, cfg_path, overrides={"model.precision": "bf16"})``."""
    from .config import ConfigNode, load_config
    from .device import resolve_device
    from .models import build_model
    from .utils.checkpoint import fold_spectral_norm, load_model_weights

    dev = resolve_device(device)
    if isinstance(config, ConfigNode):
        cfg = config.clone()
    else:
        path = config
        if not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(_REPO_ROOT, path)
        cfg = load_config(path)
    cfg.model.weights = weights
    if overrides:
        flat = []
        for k, v in overrides.items():
            flat += [k, str(v)]
        cfg.merge_from_list(flat)

    model = fold_spectral_norm(load_model_weights(build_model(cfg.model, device="cpu"), cfg))
    return model.to(dev), cfg
