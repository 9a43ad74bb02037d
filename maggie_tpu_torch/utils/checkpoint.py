"""Weight loading and inference-time spectral-norm folding (port of
``maggie_tpu/utils/checkpoint.py::load_model_weights``, ``_load_torch_file``
and ``fold_spectral_norm``)."""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import _SpectralNorm

logger = logging.getLogger(__name__)

_NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1 item 9 leaves safetensors, "
               "orbax and hub weights for later): point model.weights at a torch "
               ".pth/.pt/.bin/.ckpt file, a snapshot dir holding pytorch_model.bin or "
               "model.pth, or a JAX-package .npz")


def load_model_weights(model: nn.Module, cfg) -> nn.Module:
    """Load ``cfg.model.weights`` into ``model`` (not yet folded) and return it.

    - a torch ``.pth/.pt/.bin/.ckpt`` file, or a snapshot dir holding
      ``pytorch_model.bin`` or ``model.pth``: the reference's ``state_dict``
      (optionally under a ``state_dict`` key) loads straight into the port's
      modules, which carry the reference's names (strict, less the unused
      ``decoder.dummy_downscale`` weights, as the JAX package's converter
      drops them);
    - a ``.npz`` of the JAX package's variables (``save_variables_npz``) goes
      through ``convert_jax``;
    - an empty ``weights`` keeps the seeded init, with a warning.

    Safetensors files, orbax dirs and hub ids raise ``FileNotFoundError``."""
    weights = cfg.model.weights
    if not weights:
        logger.warning("No weights specified; using the seeded random init")
        return model
    path = weights
    if os.path.isdir(weights):
        found = [p for p in (os.path.join(weights, c) for c in ("pytorch_model.bin", "model.pth"))
                 if os.path.isfile(p)]
        if not found:
            raise FileNotFoundError(f"{weights!r}: a dir without pytorch_model.bin or "
                                    f"model.pth (a safetensors or orbax checkpoint) {_NOT_PORTED}")
        path = found[0]
    if path.endswith((".npz", ".pth", ".pt", ".bin", ".ckpt")) and not os.path.isfile(path):
        raise FileNotFoundError(f"Cannot load weights from {path!r}: no such file")
    if path.endswith(".npz"):
        from .convert_jax import convert_jax
        with np.load(path, allow_pickle=False) as data:
            flat = dict(data.items())
        sd = convert_jax(flat, model, n_block=int(cfg.model.decoder_args.get("atten_block", 2)))
    elif path.endswith((".pth", ".pt", ".bin", ".ckpt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        # the reference's index-book convs: their weights are never used, and
        # the port derives the active sets itself (models/sparse_layers.py)
        sd = {k: v for k, v in sd.items() if ".dummy_downscale." not in k}
    else:
        raise FileNotFoundError(f"Cannot load weights from {weights!r}: this kind of "
                                f"checkpoint (safetensors, orbax dir or hub id) {_NOT_PORTED}")
    model.load_state_dict(sd, strict=True)
    logger.info(f"Loaded weights from {path}")
    return model


def fold_spectral_norm(model: nn.Module) -> nn.Module:
    """weight_bar := weight_bar / sigma with sigma = u . (W v) for every
    spectral-normed conv, then drop the u/v buffers; the modules then skip the
    per-forward sigma (the reference runs a power step on every forward, eval
    included: ``spectral_norm.py:73-80``). In place; returns ``model``.

    Each module flattens its own weight layout: (O, I*kh*kw) for a conv and
    (I, O*kh*kw) for a transposed conv, also when I == O. The JAX package picks
    the layout by comparing u's length with the output channels
    (``maggie_tpu/utils/checkpoint.py:209-212``), which takes the conv layout for
    a transposed conv with I == O, such as the decoder's first upsampler."""
    for m in model.modules():
        if isinstance(m, _SpectralNorm):
            m.fold()
    return model
