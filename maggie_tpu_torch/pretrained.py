"""One-call model loading, the reference's ``MaGGIe.from_pretrained`` surface
(port of ``maggie_tpu/pretrained.py``).

    model, cfg = maggie_tpu_torch.pretrained.from_pretrained(
        "weights/maggie_image.safetensors", config="configs/maggie_image.yaml")
    out = model(batch)   # on the card

``weights`` is a local torch ``.pth``/``.bin``/``.safetensors`` file or
snapshot dir, or a JAX package ``.npz`` (``utils/checkpoint.py``); spectral
norm is folded for eval. The two model-zoo ids (``docs/MODEL_ZOO.md``) map to
their configs, as in the JAX package, so ``config`` may be left out for them;
any other ``weights`` needs ``config``. Nothing is downloaded: a zoo id that
names no local file or dir raises ``FileNotFoundError`` with the offline
recipe."""

from __future__ import annotations

import os
from typing import Any

ZOO_CONFIGS = {
    # reference docs/MODEL_ZOO.md:8-9
    "chuonghm/maggie-image-him50k-cvpr24": "configs/maggie_image.yaml",
    "chuonghm/maggie-video-vim2k5-cvpr24": "configs/maggie_video.yaml",
}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def zoo_config(weights: str, config: Any = None):
    """The config ``from_pretrained`` uses: ``config`` when given (a
    ``ConfigNode``, cloned, or a path), else the zoo id's config file. An
    unknown id without ``config`` raises ``ValueError``; a zoo id with no
    local file or dir of that name raises ``FileNotFoundError``."""
    from .config import ConfigNode, load_config

    if isinstance(config, ConfigNode):
        return config.clone()
    path = config or ZOO_CONFIGS.get(weights)
    if path is None:
        raise ValueError(f"{weights!r} is not a known model-zoo id ({sorted(ZOO_CONFIGS)}); "
                         f"pass config= explicitly")
    if weights in ZOO_CONFIGS and not os.path.exists(weights):
        raise FileNotFoundError(
            f"{weights!r} is a model-zoo id, and the port downloads nothing: fetch its "
            f"checkpoint elsewhere, then point `weights` at a local `.safetensors`/`.bin` "
            f"(or the snapshot dir holding it), with config={path!r}")
    if not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(_REPO_ROOT, path)
    return load_config(path)


def from_pretrained(weights: str, config: Any = None, overrides: dict | None = None,
                    device=None):
    """Returns ``(model, cfg)``: the model in eval mode on ``device`` (CUDA
    unless the caller passes "cpu"; raises without a GPU).

    ``config`` is a ``ConfigNode`` or a config file's path (relative paths also
    resolve against the repo root); for a zoo id it may be left out.
    ``overrides`` is a dict of dotted config overrides, e.g.
    ``from_pretrained(w, cfg_path, overrides={"model.precision": "bf16"})``."""
    from .device import resolve_device
    from .models import build_model
    from .utils.checkpoint import fold_spectral_norm, load_model_weights

    dev = resolve_device(device)
    cfg = zoo_config(weights, config)
    cfg.model.weights = weights
    if overrides:
        flat = []
        for k, v in overrides.items():
            flat += [k, str(v)]
        cfg.merge_from_list(flat)

    model = fold_spectral_norm(load_model_weights(build_model(cfg.model, device="cpu"), cfg))
    return model.to(dev), cfg
