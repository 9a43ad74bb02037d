"""Weights and train checkpoints (port of ``maggie_tpu/utils/checkpoint.py``).

- ``load_model_weights``: a torch file, a snapshot dir or a JAX-package
  ``.npz`` into an eval model; ``fold_spectral_norm`` for inference;
- ``save_train_state`` / ``restore_train_state``: the train loop's
  ``last_state.pt``, the model's ``state_dict`` (BatchNorm statistics and
  spectral-norm u/v included), the optimizer's state and the update count
  (the JAX package writes an orbax dir; its roles, ``last_model`` with the
  optimizer and the iteration, are the reference's, ``engine/train.py:313-343``);
- ``save_variables_npz``: the model in the JAX package's variables layout
  (``params/...``, ``batch_stats/...``, ``spectral/...``), as its
  ``best_model.npz``, so that both packages' eval reads it;
- ``partial_load``: the shape-tolerant load of pretrained parameters from such
  an ``.npz`` (reference ``engine/train.py:80-96``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import _SpectralNorm
from .convert_jax import key_map, to_jax

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


def _n_block(model: nn.Module) -> int:
    """The attention blocks of the flagship decoder (its ``atten_block``)."""
    return len(model.decoder.refine_OS8.sa_layers)


def save_train_state(path: str, state) -> None:
    """``state`` (``engine.train_step.TrainState``) to ``path``: the model's
    ``state_dict``, the optimizer's and the update count."""
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, path)


def restore_train_state(path: str, state) -> None:
    """Load ``path`` (``save_train_state``) into ``state`` in place, on the
    model's device; every tensor equals the saved one bit for bit."""
    dev = next(state.model.parameters()).device
    saved = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])


def save_variables_npz(path: str, model: nn.Module) -> None:
    """The (unfolded) model's parameters, BatchNorm statistics and spectral u/v
    in the JAX package's flat variables layout (``save_variables_npz`` there),
    through ``convert_jax.to_jax``."""
    np.savez(path, **to_jax(model.state_dict(), n_block=_n_block(model)))


@torch.no_grad()
def partial_load(model: nn.Module, flat: dict[str, np.ndarray]) -> tuple[list, list, list]:
    """Copy the ``params/...`` arrays of a JAX-layout flat dict into the model's
    parameters where the key maps to one and the shapes agree; keep the rest
    and log the missing, unexpected and shape-mismatched keys (JAX names).
    Returns ``(missing, unexpected, mismatched)``."""
    flat = {k: v for k, v in flat.items() if k.startswith("params/")}
    params = dict(model.named_parameters())
    missing, mismatched, used = [], [], set()
    for tkey, jkey, fn in key_map(_n_block(model)):
        if tkey not in params or not jkey.startswith("params/"):
            continue
        if jkey not in flat:
            missing.append(jkey)
            continue
        value = np.asarray(flat[jkey])
        value = value if fn is None else np.transpose(value, fn)
        used.add(jkey)
        if tuple(value.shape) != tuple(params[tkey].shape):
            mismatched.append((jkey, tuple(params[tkey].shape), tuple(value.shape)))
            continue
        params[tkey].copy_(torch.from_numpy(np.ascontiguousarray(value)))
    unexpected = sorted(k for k in flat if k not in used)
    if missing:
        logger.warning(f"Missing keys ({len(missing)}): {missing[:10]}...")
    if unexpected:
        logger.warning(f"Unexpected keys ({len(unexpected)}): {unexpected[:10]}...")
    if mismatched:
        logger.warning(f"Shape-mismatched keys: {mismatched[:10]}...")
    return missing, unexpected, mismatched
