"""Model registries of the port: the MaGGIe image model (arch ``MaGGIe``), the
MaGGIe video model (arch ``MaGGIe_Temp``), the MGM baseline family (arch
``MGM``, ``MGM_SingInst``, ``TCVOM``, ``TCVOM_SingInst``) and SparseMat (arch
``SparseMat``, ``SparseMat_SingInst``), eval and train; besides, the dense
InstMatt ablation decoder ``res_shortcut_inst_matt_22`` and the plain
``ResNetD`` encoder ``res_encoder_29`` (which no harness takes: ROADMAP.md
queue 3); and the passthrough arch ``Dummy`` (the input masks as the
prediction). Every other name raises and points to ROADMAP.md.

The encoders take the JAX package's off-by-default flags ``s2d_stem`` and
``lazy_os2_shortcut`` (``maggie_tpu/models/__init__.py:11-35``) and read
neither: both are TPU forms of the same numbers. ``s2d_stem`` runs the 3x3
stride-2 stem conv as a 2x2 conv on the space-to-depth input
(``maggie_tpu/models/layers.py:66-72,101-119``), the same sum in another
order; ``lazy_os2_shortcut`` defers ``shortcut.1`` to the ladder's patches
at eval, which the JAX package asserts bit-equal to the dense branch
(``tests/test_blocksparse.py:91-113``) and which computes 2.3x the dense
map's sites at the bench's capacity. So the port runs the ordinary stem conv
and the dense ``shortcut.1``; ``maggie.py`` keeps the JAX package's refusal
of lazy os2 off ``block`` mode."""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn as nn

from ..device import resolve_device
from .layers import init_weights

_LATER = "is not ported yet; ROADMAP.md queue 1 lists the order of the port"


def _enc_res_shortcut_embed_29(args: dict) -> nn.Module:
    from .encoder import ResMaskEmbedShortCutD
    return ResMaskEmbedShortCutD(
        layers=(3, 4, 4, 2), num_mask=int(args.get("num_mask", 10)),
        num_embed=int(args.get("num_embed", 3)),
        lazy_os1_shortcut=bool(args.get("lazy_os1_shortcut", False)))


def _enc_res_shortcut_29(args: dict) -> nn.Module:
    """The MGM encoder: RGB | ``num_mask`` masks in, no mask embedding
    (``maggie_tpu/models/__init__.py:24-29``)."""
    from .encoder import ResShortCutD
    return ResShortCutD(3 + int(args.get("num_mask", 1)), (3, 4, 4, 2),
                        lazy_os1_shortcut=bool(args.get("lazy_os1_shortcut", False)))


def _enc_res_encoder_29(args: dict) -> nn.Module:
    """``ResNetD``: the trunk alone, returning the pyramid dict
    (``maggie_tpu/models/__init__.py:32-35``); input RGB | ``num_mask`` masks."""
    from .encoder import ResNetD
    return ResNetD(3 + int(args.get("num_mask", 1)), (3, 4, 4, 2))


def _dec_inst_matt_spconv(args: dict) -> nn.Module:
    from .decoder_sparse import ResShortCutInstMattSpconvDec
    return ResShortCutInstMattSpconvDec(**args)


def _dec_inst_matt_spconv_temp(args: dict) -> nn.Module:
    from .decoder_video import ResShortCutInstMattSpconvTempDec
    return ResShortCutInstMattSpconvTempDec(**args)


def _dec_res_shortcut_22(args: dict) -> nn.Module:
    from .decoder_dense import ResShortCutDec
    return ResShortCutDec(**args)


def _dec_inst_matt_dense(args: dict) -> nn.Module:
    from .decoder_inst_dense import ResShortCutInstMattDec
    return ResShortCutInstMattDec(**args)


def _dec_res_shortcut_fam_22(args: dict) -> nn.Module:
    from .decoder_fam import ResShortCutFAMDec
    return ResShortCutFAMDec(**args)


def _archs() -> dict:
    from .maggie import Dummy, MaGGIe
    from .maggie_temp import MaGGIeTemp
    from .mgm_wrappers import MGMSingInst
    from .sparsemat import SparseMat, SparseMatSingInst
    from .tcvom import TCVOM, TCVOMSingInst
    # MGM shares the MaGGIe harness with the dense decoder (maggie_tpu/models/__init__.py:104)
    return {"MaGGIe": MaGGIe, "MaGGIe_Temp": MaGGIeTemp, "MGM": MaGGIe,
            "MGM_SingInst": MGMSingInst, "TCVOM": TCVOM, "TCVOM_SingInst": TCVOMSingInst,
            "SparseMat": SparseMat, "SparseMat_SingInst": SparseMatSingInst, "Dummy": Dummy}


ENCODERS: dict[str, Callable[[dict], nn.Module]] = {
    "res_shortcut_embed_29": _enc_res_shortcut_embed_29,
    "res_shortcut_29": _enc_res_shortcut_29,
    "res_encoder_29": _enc_res_encoder_29,
}
DECODERS: dict[str, Callable[[dict], nn.Module]] = {
    "res_shortcut_inst_matt_spconv_22": _dec_inst_matt_spconv,
    "res_shortcut_inst_matt_spconv_temp_22": _dec_inst_matt_spconv_temp,
    "res_shortcut_inst_matt_22": _dec_inst_matt_dense,
    "res_shortcut_22": _dec_res_shortcut_22,
    "res_shortcut_fam_22": _dec_res_shortcut_fam_22,
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
    archs = _archs()
    arch = archs.get(model_cfg.arch)
    if arch is None:
        raise KeyError(f"arch '{model_cfg.arch}' {_LATER}. Ported: {sorted(archs)}")
    # construct on the meta device so that no default initializer draws from
    # the global RNG; every tensor is then filled from the explicit generator
    with torch.device("meta"):
        model = arch(model_cfg)
    model = model.to_empty(device="cpu")
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    return model.to(dev).eval()
