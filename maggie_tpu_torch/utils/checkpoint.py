"""Inference-time spectral-norm folding (port of
``maggie_tpu/utils/checkpoint.py::fold_spectral_norm``)."""

from __future__ import annotations

import torch.nn as nn

from ..models.layers import _SpectralNorm


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
