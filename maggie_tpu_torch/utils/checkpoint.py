"""Weights and train checkpoints (port of ``maggie_tpu/utils/checkpoint.py``).

- ``load_model_weights``: a torch file, a ``.safetensors`` file
  (``read_safetensors``), a snapshot dir or a JAX-package ``.npz`` into an
  eval model; ``fold_spectral_norm`` for inference;
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

import json
import logging
import os

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import _SpectralNorm
from .convert_jax import key_map, to_jax

logger = logging.getLogger(__name__)

_NOT_PORTED = ("is not ported (orbax dirs and hub downloads are not read): point "
               "model.weights at a local .safetensors/.bin/.pth file, a snapshot dir holding "
               "pytorch_model.bin, model.safetensors or model.pth, or a JAX-package .npz "
               "(maggie_tpu.utils.checkpoint.save_variables_npz writes one from an orbax "
               "checkpoint)")
_SNAPSHOT_FILES = ("pytorch_model.bin", "model.safetensors", "model.pth")
_TORCH_SUFFIXES = (".pth", ".pt", ".bin", ".ckpt", ".safetensors")
# safetensors dtype names -> numpy dtypes (little-endian, as the format stores them)
_ST_DTYPES = {"BOOL": "?", "U8": "u1", "I8": "i1", "U16": "<u2", "I16": "<i2", "F16": "<f2",
              "U32": "<u4", "I32": "<i4", "F32": "<f4", "U64": "<u8", "I64": "<i8",
              "F64": "<f8"}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, read with numpy and ``json``:
    an 8-byte little-endian header length, a JSON header naming each
    tensor's dtype, shape and byte range, then the raw arrays.

    BOOL, the integer types, F16, F32 and F64 come out as the arrays
    ``safetensors.numpy.load_file`` gives (the JAX package's reader), as CPU
    tensors. BF16 comes out as torch bf16. That reader gives it only where
    ml_dtypes has registered bfloat16 with numpy (importing JAX does), and
    raises ``TypeError`` elsewhere. Other dtypes (F8) raise ``ValueError``."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path!r} is not a safetensors file: {len(raw)} bytes")
    n = int(np.frombuffer(raw[:8], "<u8")[0])
    if 8 + n > len(raw):
        raise ValueError(f"{path!r} is not a safetensors file: a header of {n} bytes "
                         f"in {len(raw)}")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(info["shape"])
        begin, end = info["data_offsets"]
        buf = data[begin:end]
        if dtype == "BF16":
            bits = np.frombuffer(buf, "<i2").reshape(shape)
            out[name] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
        elif dtype in _ST_DTYPES:
            out[name] = torch.from_numpy(np.frombuffer(buf, _ST_DTYPES[dtype]).reshape(shape).copy())
        else:
            raise ValueError(f"{path!r}: tensor {name!r} has dtype {dtype}, which the port "
                             f"does not read")
    return out


def load_model_weights(model: nn.Module, cfg) -> nn.Module:
    """Load ``cfg.model.weights`` into ``model`` (not yet folded) and return it.

    - a torch ``.pth/.pt/.bin/.ckpt`` file, a ``.safetensors`` file, or a
      snapshot dir holding ``pytorch_model.bin``, ``model.safetensors`` or
      ``model.pth`` (searched in that order, as the JAX package does): the
      reference's ``state_dict`` (optionally under a ``state_dict`` key)
      loads straight into the port's modules, which carry the reference's
      names (strict, less the unused ``decoder.dummy_downscale`` weights, as
      the JAX package's converter drops them); a model with ``atten_stride``
      > 1 needs its ``ori_feat_proj`` weight there, which no released
      checkpoint is known to hold, and a file without it raises ``KeyError``
      naming the route through the JAX package's ``.npz``;
    - a ``.npz`` of the JAX package's variables (``save_variables_npz``) goes
      through ``convert_jax``;
    - an empty ``weights`` keeps the seeded init, with a warning.

    Orbax dirs and hub ids raise ``FileNotFoundError`` naming the offline
    route."""
    weights = cfg.model.weights
    if not weights:
        logger.warning("No weights specified; using the seeded random init")
        return model
    path = weights
    if os.path.isdir(weights):
        found = [p for p in (os.path.join(weights, c) for c in _SNAPSHOT_FILES)
                 if os.path.isfile(p)]
        if not found:
            raise FileNotFoundError(f"{weights!r}: a dir without {' or '.join(_SNAPSHOT_FILES)} "
                                    f"(an orbax checkpoint) {_NOT_PORTED}")
        path = found[0]
    if path.endswith((".npz",) + _TORCH_SUFFIXES) and not os.path.isfile(path):
        raise FileNotFoundError(f"Cannot load weights from {path!r}: no such file")
    if path.endswith(".npz"):
        from .convert_jax import convert_jax
        with np.load(path, allow_pickle=False) as data:
            flat = dict(data.items())
        sd = convert_jax(flat, model, n_block=int(cfg.model.decoder_args.get("atten_block", 2)))
    elif path.endswith(_TORCH_SUFFIXES):
        if path.endswith(".safetensors"):
            sd = read_safetensors(path)
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        # the reference's index-book convs: their weights are never used, and
        # the port derives the active sets itself (models/sparse_layers.py)
        sd = {k: v for k, v in sd.items() if ".dummy_downscale." not in k}
        proj = [k for k in model.state_dict() if ".ori_feat_proj." in k and k not in sd]
        if proj:
            raise KeyError(f"{path!r} has no {proj[0]}, the 1x1 projection that "
                           f"model.decoder_args.atten_stride > 1 adds; no torch checkpoint "
                           f"reader maps it (ROADMAP.md queue 3): carry such weights from the "
                           f"JAX package as a .npz (save_variables_npz), or use atten_stride 1")
    else:
        raise FileNotFoundError(f"Cannot load weights from {weights!r}: this kind of "
                                f"checkpoint (an orbax dir or a hub id) {_NOT_PORTED}")
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
    """The attention blocks of the MaGGIe decoder (its ``atten_block``; the
    MGM family's decoders and SparseMat have none)."""
    return len(getattr(getattr(getattr(model, "decoder", None), "refine_OS8", None),
                       "sa_layers", ()))


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
    for tkey, jkey, fn in key_map(_n_block(model), params):
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
