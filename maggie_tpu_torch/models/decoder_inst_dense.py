"""The dense InstMatt ablation decoder ``res_shortcut_inst_matt_22`` (port of
``maggie_tpu/models/decoder_inst_dense.py``; reference
``decoder/resnet_inst_matt.py``), NCHW.

MaGGIe's decoder without the sparse ladder: the instance-query attention at
os8 (``InstanceMatteDecoder``) gives the os8 logits and features; dense
decoder layers with the encoder's skip features and two dense heads
(``RefineHead``, ``max_inst`` channels) give the os4 and os1 logits. Its own
fusion runs on the os8 alpha, detached: the os4 alpha where the os8 alpha's
uncertain band (k=30) reaches, then the os1 alpha where the result's band
(k=15) does (reference ``:116-131``).

K2 (``ops/kernels/unknown.py::compute_unknown``) computes ``detail_mask``
(k=30 on the os8 alpha, also in training) and, in eval, the fusion's two
bands (``maggie.prm_fuse``, the harness's fusion): three launches an eval
forward. In training the fusion's bands are the random-width dilations
(``compute_unknown_random``): one launch a step. The heads' logits are cast to f32
before the alphas (``:85``); the os8 logits come f32 from the attention.
The decoder runs its train forward as one stage (``train_forward``): the
JAX decoder tags nothing, so under ``model.remat selective`` its segment,
K2 included, is recomputed whole (two K2 launches a step, as under
``full``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import remat
from .decoder_dense import RefineHead
from .decoder_sparse import TrainStep
from .instance_decoder import InstanceMatteDecoder
from .layers import BatchNorm, SNConvTranspose, leaky_relu, res_layer_dec
from .maggie import prm_fuse
from ..ops.kernels.unknown import compute_unknown
from ..ops.resize import resize_any_shape, resize_bilinear


def _alpha(logit: torch.Tensor) -> torch.Tensor:
    return (torch.tanh(logit) + 1.0) / 2.0


class ResShortCutInstMattDec(nn.Module):
    def __init__(self, layers=(2, 3, 3, 2), atten_stride: float = 1.0, atten_dim: int = 128,
                 atten_block: int = 2, atten_head: int = 1, final_channel: int = 64,
                 max_inst: int = 10, use_id_pe: bool = True, large_kernel: bool = False,
                 late_downsample: bool = False, **_unused):
        super().__init__()
        if float(atten_stride) != 1.0:
            raise NotImplementedError("atten_stride != 1 is not ported yet (ROADMAP.md queue 1 "
                                      "item 14)")
        k = 5 if large_kernel else 3
        midplanes = 64 if late_downsample else 32
        self.layer1 = res_layer_dec(512, 256, layers[0], 2)
        self.layer2 = res_layer_dec(256, 128, layers[1], 2)
        self.refine_OS8 = InstanceMatteDecoder(
            input_dim=128, attention_dim=atten_dim, n_block=atten_block, n_head=atten_head,
            output_dim=final_channel, max_inst=max_inst, use_id_pe=use_id_pe)
        self.layer3 = res_layer_dec(final_channel, 64, layers[2], 2)
        self.refine_OS4 = RefineHead(64, 32, max_inst, k)
        self.layer4 = res_layer_dec(64, midplanes, layers[3], 2)
        self.conv1 = SNConvTranspose(midplanes, 32)
        self.bn1 = BatchNorm(32)
        self.refine_OS1 = RefineHead(32, 32, max_inst, k)

    def _os8(self, x, fea5, fea4, masks5, gt_masks=None, use_mask_atten=False):
        """(os8 logits f32, os8 features, attention loss)."""
        z = self.layer1(x) + fea5
        z = self.layer2(z) + fea4
        logit, feat8, _, loss_max_atten, _ = self.refine_OS8(z, masks5, gt_masks, use_mask_atten)
        return logit, feat8, loss_max_atten

    def _heads(self, feat8, fea3, fea2, fea1, size):
        """The os4 and os1 alphas at ``size``, f32."""
        z = self.layer3(feat8) + fea3
        x_os4 = self.refine_OS4(z)
        z = self.layer4(z) + fea2
        z = leaky_relu(self.bn1(self.conv1(z))) + fea1
        x_os1 = self.refine_OS1(z)
        return (_alpha(resize_bilinear(x_os4.float(), size)), _alpha(x_os1.float()))

    def forward(self, x, mid_fea: dict, b: int, n_f: int, n_i: int, masks, gt_alphas=None,
                use_mask_atten: bool = False, use_gt_guidance: bool = False,
                generator: torch.Generator | None = None, **_unused) -> dict:
        """x (b*n_f, 512, h32, w32); masks (b*n_f, n_i_in, H, W) guidance
        masks. Eval returns the first ``n_i`` slots' alphas, the fused alpha,
        the fusion's two bands and ``detail_mask``; train mode
        (``train_forward``) all slots' and the attention loss."""
        if self.training:
            step = TrainStep(b, n_f, masks, gt_alphas, None, use_mask_atten, use_gt_guidance,
                             generator)
            return self.train_forward(remat.Stages(), x, mid_fea["shortcut"], step)
        fea1, fea2, fea3, fea4, fea5 = mid_fea["shortcut"]
        size = mid_fea["image"].shape[2:]
        masks5 = masks.reshape((b, n_f) + masks.shape[1:])
        logit, feat8, _ = self._os8(x, fea5, fea4, masks5)
        # exact: resize and tanh act per channel
        x_os8 = _alpha(resize_bilinear(logit[:, :n_i], size))
        unknown_os8 = compute_unknown(x_os8, 30)
        x_os4, x_os1 = (t[:, :n_i] for t in self._heads(feat8, fea3, fea2, fea1, size))
        alpha, w4, w1 = prm_fuse(x_os8, x_os4, x_os1, False)
        return {"alpha_os1": x_os1, "alpha_os4": x_os4, "alpha_os8": x_os8,
                "refined_masks": alpha, "weight_os4": w4, "weight_os1": w1,
                "detail_mask": unknown_os8}

    def train_forward(self, run, x, feas, step: TrainStep):
        """The train forward from the ASPP output ``x`` and the encoder's
        ``feas`` (fea1 to fea5) as one stage through ``run``, ending in the
        arch's losses (``step.finish``)."""
        return run(self._train_stage, x, *feas, step)

    def _train_stage(self, x, fea1, fea2, fea3, fea4, fea5, step: TrainStep):
        masks = step.masks
        size = masks.shape[-2:]
        masks5 = masks.reshape((step.b, step.n_f) + masks.shape[1:])
        gt_masks = None
        if step.gt_alphas is not None:
            gt_masks = (step.gt_alphas > 0).float().reshape(
                (step.b, step.n_f) + step.gt_alphas.shape[1:])
            if gt_masks.shape[-1] != masks5.shape[-1]:
                gt_masks = resize_any_shape(gt_masks, use_max_pool=True,
                                            scale_factor=masks5.shape[-1] / gt_masks.shape[-1])
        logit, feat8, loss_max_atten = self._os8(x, fea5, fea4, masks5, gt_masks,
                                                 step.use_mask_atten)
        x_os8 = _alpha(resize_bilinear(logit, size))
        x_os8 = x_os8 * (masks.sum(dim=(2, 3), keepdim=True) > 0).float()
        # eval-mode K2 even in training (:75)
        unknown_os8 = compute_unknown(x_os8, 30)
        x_os4, x_os1 = self._heads(feat8, fea3, fea2, fea1, size)
        # the fusion on the detached os8 alpha (:120-129)
        alpha, w4, w1 = prm_fuse(x_os8.detach(), x_os4, x_os1, True, step.generator)
        pred = {"alpha_os1": x_os1, "alpha_os4": x_os4, "alpha_os8": x_os8,
                "refined_masks": alpha, "weight_os4": w4, "weight_os1": w1,
                "detail_mask": unknown_os8, "loss_max_atten": loss_max_atten}
        return pred if step.finish is None else step.finish(pred)
