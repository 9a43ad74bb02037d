"""Model registries of the port: the MaGGIe image model (arch ``MaGGIe``) and
the MaGGIe video model (arch ``MaGGIe_Temp``), eval and train; every other
name raises and points to ROADMAP.md."""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn as nn

from ..device import resolve_device
from .layers import init_weights

_LATER = "is not ported yet; ROADMAP.md queue 1 lists the order of the port"


def _enc_res_shortcut_embed_29(args: dict) -> nn.Module:
    from .encoder import ResMaskEmbedShortCutD
    for flag in ("lazy_os2_shortcut", "s2d_stem"):
        if args.get(flag, False):
            raise NotImplementedError(f"encoder_args.{flag} {_LATER} (item 14)")
    return ResMaskEmbedShortCutD(
        layers=(3, 4, 4, 2), num_mask=int(args.get("num_mask", 10)),
        num_embed=int(args.get("num_embed", 3)),
        lazy_os1_shortcut=bool(args.get("lazy_os1_shortcut", False)))


def _dec_inst_matt_spconv(args: dict) -> nn.Module:
    from .decoder_sparse import ResShortCutInstMattSpconvDec
    return ResShortCutInstMattSpconvDec(**args)


def _dec_inst_matt_spconv_temp(args: dict) -> nn.Module:
    from .decoder_video import ResShortCutInstMattSpconvTempDec
    return ResShortCutInstMattSpconvTempDec(**args)


def _arch(name: str):
    from .maggie import MaGGIe
    from .maggie_temp import MaGGIeTemp
    return {"MaGGIe": MaGGIe, "MaGGIe_Temp": MaGGIeTemp}.get(name)


ENCODERS: dict[str, Callable[[dict], nn.Module]] = {
    "res_shortcut_embed_29": _enc_res_shortcut_embed_29,
}
DECODERS: dict[str, Callable[[dict], nn.Module]] = {
    "res_shortcut_inst_matt_spconv_22": _dec_inst_matt_spconv,
    "res_shortcut_inst_matt_spconv_temp_22": _dec_inst_matt_spconv_temp,
}


def build_encoder(name: str, args: dict) -> nn.Module:
    if name not in ENCODERS:
        raise KeyError(f"encoder '{name}' {_LATER}. Ported: {sorted(ENCODERS)}")
    return ENCODERS[name](args)


def build_decoder(name: str, args: dict) -> nn.Module:
    if name not in DECODERS:
        raise KeyError(f"decoder '{name}' {_LATER}. Ported: {sorted(DECODERS)}")
    return DECODERS[name](args)


def build_model(model_cfg: Any, device: str | torch.device | None = None,
                generator: torch.Generator | None = None) -> nn.Module:
    """Build the model on ``device`` (CUDA unless the caller passes ``"cpu"``),
    in eval mode, with every parameter drawn on the CPU from ``generator``
    (``torch.Generator().manual_seed(0)`` when none is given)."""
    dev = resolve_device(device)
    arch = _arch(model_cfg.arch)
    if arch is None:
        raise KeyError(f"arch '{model_cfg.arch}' {_LATER}. Ported: ['MaGGIe', 'MaGGIe_Temp']")
    # construct on the meta device so that no default initializer draws from
    # the global RNG; every tensor is then filled from the explicit generator
    with torch.device("meta"):
        model = arch(model_cfg)
    model = model.to_empty(device="cpu")
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
