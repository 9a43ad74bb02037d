"""MaGGIe video arch (port of ``maggie_tpu/models/maggie_temp.py``; reference
``network/arch/maggie_temp.py``): the image arch with the video decoder, whose
forward and backward change maps are returned as ``diff_pred_forward`` /
``diff_pred_backward`` (one map per frame, broadcast over the instances)
beside ``temp_alpha``; in train the decoder's temporal losses join the loss
dict (``loss_temp`` into ``total``, ``:14-34``), and in eval the temporal rule
runs over a 3-frame window (``_finalize_eval``, ``:43-62``)."""

from __future__ import annotations

import torch

from .maggie import MaGGIe


class MaGGIeTemp(MaGGIe):

    def _transform_output(self, pred: dict, b, n_f, n_i, h, w) -> dict:
        out = super()._transform_output(pred, b, n_f, n_i, h, w)
        if "diff_backward" in pred:
            shape = (b, n_f, n_i, h, w)
            out["diff_pred_forward"] = pred["diff_forward"].expand(shape)
            out["diff_pred_backward"] = pred["diff_backward"].expand(shape)
            out["temp_alpha"] = pred["temp_alpha"]
        return out

    def _extra_losses(self, pred: dict, loss_dict: dict) -> None:
        if "loss_temp" in pred:
            for k in ("loss_temp_bce", "loss_temp_dtssd", "loss_temp"):
                loss_dict[k] = pred[k]
            loss_dict["total"] = loss_dict["total"] + pred["loss_temp"]

    def _finalize_eval(self, output: dict, prev_pred) -> dict:
        """Frame 1 of the window takes the previous window's frame 1
        (``prev_pred``, else this window's frame 0) where the forward change
        map says frame 1 changed little, unless the backward rule from frame
        2 disagrees; frame 2 then follows frame 1 where it changed little
        (reference ``:37-75``). The change maps are thresholded at 0.5 and
        the disagreement is an exact comparison, as there."""
        if "diff_pred_forward" not in output:
            return output
        alphas = output["refined_masks"]                          # (1, n_f, n_i, H, W)
        pp = prev_pred if prev_pred is not None else alphas[:, 0]
        next_pred = alphas[:, -1]
        diff_fwd = (output["diff_pred_forward"] > 0.5).to(alphas.dtype)
        diff_bwd = (output["diff_pred_backward"] > 0.5).to(alphas.dtype)
        pred_f01 = pp * (1 - diff_fwd[:, 1]) + alphas[:, 1] * diff_fwd[:, 1]
        pred_b21 = next_pred * (1 - diff_bwd[:, 1]) + alphas[:, 1] * diff_bwd[:, 1]
        pred_f01 = torch.where((pred_f01 - pred_b21).abs() > 0.0, alphas[:, 1], pred_f01)
        frame2 = pred_f01 * (1 - diff_fwd[:, 2]) + next_pred * diff_fwd[:, 2]
        output["refined_masks"] = torch.cat(
            [alphas[:, :1], pred_f01[:, None], frame2[:, None], alphas[:, 3:]], dim=1)
        return output
