"""MaGGIe architecture, eval: encoder -> ASPP -> decoder with PRM fusion
(port of the eval branch of ``maggie_tpu/models/maggie.py``; reference
``network/arch/maggie.py``).

Interface as in the JAX package: ``batch['image']`` (b, n_f, H, W, 3) float,
``batch['mask']`` (b, n_f, n_i, hm, wm); outputs are (b, n_f, n_i, H, W).
The forward is always the eval forward; training comes with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .aspp import ASPP
from ..ops.resize import resize_nearest

_LAZY_OS1_DECODERS = ("res_shortcut_inst_matt_spconv_22",)
_LAZY_OS1_ENCODERS = ("res_shortcut_embed_29",)


class MaGGIe(nn.Module):
    """``cfg`` is the ``model`` subtree of the config."""

    def __init__(self, cfg):
        super().__init__()
        from . import build_decoder, build_encoder
        self.num_masks = int(cfg["encoder_args"].get("num_mask", 1))
        enc_args = dict(cfg["encoder_args"])
        # the block-sparse decoder reads the os1 skip features only at selected
        # blocks: defer that encoder branch to patch domain unless overridden
        # (maggie_tpu/models/maggie.py:44-50)
        if (cfg["decoder"] in _LAZY_OS1_DECODERS
                and cfg["decoder_args"].get("sparse_mode") == "block"
                and not cfg["decoder_args"].get("phase_rung", False)
                and "lazy_os1_shortcut" not in enc_args
                and cfg["encoder"] in _LAZY_OS1_ENCODERS):
            enc_args["lazy_os1_shortcut"] = True
        self.encoder = build_encoder(cfg["encoder"], enc_args)
        self.aspp = ASPP(cfg["aspp"]["in_channels"], cfg["aspp"]["out_channels"])
        self.decoder = build_decoder(cfg["decoder"], dict(cfg["decoder_args"]))
        self.compute_dtype = (torch.bfloat16 if str(cfg.get("precision", "fp32")) in
                              ("bf16", "bfloat16", "16") else torch.float32)

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        x = batch["image"]                      # (b, n_f, H, W, 3)
        masks = batch["mask"]                   # (b, n_f, n_i, hm, wm)
        b, n_f, h, w, _ = x.shape
        n_i = masks.shape[2]
        x = x.reshape(b * n_f, h, w, 3).permute(0, 3, 1, 2).to(self.compute_dtype)
        masks = masks.reshape((b * n_f, n_i) + masks.shape[-2:])
        if masks.shape[-1] != w:
            masks = resize_nearest(masks, (h, w))
        masks = masks.to(x.dtype)

        # encoder input (reference prepare_input, :200-235): RGB | masks padded
        # with zero slots up to num_masks
        inp = x
        if self.num_masks > 0:
            inp_masks = masks
            if self.num_masks > n_i:
                pad = masks.new_zeros((b * n_f, self.num_masks - n_i, h, w))
                inp_masks = torch.cat([masks, pad], dim=1)
            inp = torch.cat([x, inp_masks], dim=1)

        embedding, mid_fea = self.encoder(inp)
        embedding = self.aspp(embedding)
        pred = self.decoder(embedding, mid_fea, b=b, n_f=n_f, n_i=n_i, masks=masks)

        # keep the true instances only, as (b, n_f, n_i, H, W)
        return {k: pred[k][:, :n_i].reshape(b, n_f, n_i, h, w)
                for k in ("alpha_os1", "alpha_os4", "alpha_os8", "refined_masks",
                          "detail_mask")}
