"""``MGM_SingInst`` (port of ``maggie_tpu/models/mgm_wrappers.py``; reference
``arch/maggie.py:370-384``): the MGM harness that, in eval, runs one instance
mask at a time and concatenates the outputs on the instance axis; in train
it is the plain harness."""

from __future__ import annotations

import torch

from .maggie import MaGGIe


def one_instance_at_a_time(forward, batch: dict) -> dict:
    """``forward`` on ``batch`` with each instance mask alone, its outputs
    concatenated on the instance axis (the SingInst archs' eval)."""
    masks = batch["mask"]
    outs = [forward({**batch, "mask": masks[:, :, i:i + 1]}) for i in range(masks.shape[2])]
    return {k: torch.cat([o[k] for o in outs], dim=2) for k in outs[0]}


class MGMSingInst(MaGGIe):
    split_eval = False

    @torch.no_grad()
    def _eval_forward(self, batch: dict, mem_feat=None, prev_pred=None) -> dict:
        return one_instance_at_a_time(super()._eval_forward, batch)
