"""Video detail decoder, eval branch (port of ``maggie_tpu/models/decoder_video.py``;
reference ``decoder/resnet_inst_matt_spconv_temp.py``,
``ResShortCut_InstMattSpconv_BiTempSpar_Dec``), NCHW.

The image decoder (``decoder_sparse.py``) plus:

- a ConvGRU over the os8 attention maps, hooked into ``refine_OS8``
  (``:157-162``): the memory-mixed maps give the os8 logits, the memory-free
  ones feed the ladder and the diff module;
- the ``>= 0.95`` snap of the os8 alpha (``:184``), K2 at k=30 on the alpha
  before the snap (``:188``), and the instance bounding-box mask (``:101-125``)
  applied to the uncertainty map and to the os8 alpha;
- the block ladder over the ``b * n_f`` frames of the window (K1), ``fuse``
  (K2 at k=27 and k=15);
- the frame-local os32 -> os8 layers and the attention's conv stack run one
  frame at a time (``layers.per_frame``);
- ``diff_module``, a conv stack that predicts a change map for each pair of
  neighbouring frames, and ``bidirectional_fusion`` (``:62-99``), which blends
  the frames' alphas with the sigmoid of those maps.

Every K2 input of this path is f32 (the os8 alpha comes from f32 logits), in
bf16 mode too. ``mem_feat``, the ConvGRU's stacked hidden state, is returned
and may seed the next window's series.

Train mode (``maggie_tpu/models/decoder_video.py:127-260``) is the image
decoder's train branch (GT guidance and its rescue, the empty-map patch, the
train ladder, random-width fusion and GT weights; no snap and no box) with
the ConvGRU hook and the video path's attention, which never masks by the
guidance (``use_mask_atten`` is ignored). Every layer runs once over all
``b * n_f`` frames, so that train-mode BatchNorm takes its statistics over
all of them. The diff module reads the os8 features with no gradient, so
that only ``loss_temporal_sparsity`` trains it; it is called 2 * (n_f - 1)
times a step, forward pairs first, and each call steps its BatchNorm
statistics and spectral norms from the state the call before left, the
gradient flowing through that chain (``layers._SpectralNorm``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import parallel
from .conv_gru import ConvGRU
from . import remat
from .decoder_sparse import ResShortCutInstMattSpconvDec, TrainStep
from .layers import BatchNorm, Conv2d, SNConv, per_frame
from .losses import loss_dtssd
from ..ops.kernels.unknown import compute_unknown
from ..ops.resize import resize_bilinear
from ..ops.smoothing import gaussian_smoothing


class DiffModule(nn.Sequential):
    """SN conv1x1 -> BN -> ReLU -> SN conv3x3 -> BN -> ReLU -> conv3x3 to one
    channel (reference ``:25-33``); keys ``.0, .1, .3, .4, .6``. Input: two
    frames' os8 features, concatenated."""

    def __init__(self, in_ch: int):
        super().__init__(SNConv(in_ch, 64, 1, 1, 0), BatchNorm(64), nn.ReLU(),
                         SNConv(64, 32, 3, 1, 1), BatchNorm(32), nn.ReLU(),
                         Conv2d(32, 1, 3, padding=1))


class ResShortCutInstMattSpconvTempDec(ResShortCutInstMattSpconvDec):
    def __init__(self, temp_method: str = "bi", atten_dim: int = 128, final_channel: int = 64,
                 **kwargs):
        super().__init__(atten_dim=atten_dim, final_channel=final_channel, **kwargs)
        self.temp_mode = temp_method.split("_")[0]
        self.use_fusion = "fusion" in temp_method
        self.use_temp = temp_method != "none"
        # the reference hard-codes ConvGRU(128), its atten_dim (:22)
        self.os8_temp_module = ConvGRU(atten_dim)
        self.diff_module = DiffModule(2 * final_channel)

    def bidirectional_fusion(self, feat: torch.Tensor, preds: torch.Tensor):
        """feat (b, n_f, C, h8, w8); preds (b, n_f, n_i, H, W). Returns the
        forward and backward diff logits (b, n_f, 1, H, W), f32, zero at the
        frame that has no predecessor (successor), and the fused alphas
        (reference ``:35-79``)."""
        n_f = feat.shape[1]
        size = preds.shape[-2:]

        def diff(a, b_):
            d = self.diff_module(torch.cat([a, b_], dim=1)).float()
            return resize_bilinear(d, size, align_corners=False)

        fwd_diffs, fwd_preds = [], [preds[:, 0]]
        for i in range(1, n_f):
            d = diff(feat[:, i - 1], feat[:, i])
            fwd_diffs.append(d)
            s = torch.sigmoid(d)
            fwd_preds.append(fwd_preds[-1] * (1 - s) + preds[:, i] * s)
        diff_forward = torch.stack([torch.zeros_like(fwd_diffs[0])] + fwd_diffs, dim=1)

        bwd_diffs, bwd_preds = [], [preds[:, n_f - 1]]
        for i in range(n_f - 1, 0, -1):
            d = diff(feat[:, i], feat[:, i - 1])
            bwd_diffs.append(d)
            s = torch.sigmoid(d)
            bwd_preds.append(bwd_preds[-1] * (1 - s) + preds[:, i - 1] * s)
        bwd_preds = bwd_preds[::-1]
        diff_backward = torch.stack(bwd_diffs[::-1] + [torch.zeros_like(bwd_diffs[-1])], dim=1)

        fused = [fwd_preds[0]] + [(fwd_preds[i] + bwd_preds[i]) / 2 for i in range(1, n_f - 1)]
        fused.append(bwd_preds[n_f - 1])
        return diff_forward, diff_backward, torch.stack(fused, dim=1)

    @staticmethod
    def _bbox_mask(x_os8: torch.Tensor) -> torch.Tensor:
        """Branchless instance box (reference ``:122-142``): per map, the box
        of the smoothed alpha above 0.1, padded by 30 px and clipped to the
        map; all ones when nothing is above 0.1."""
        thresh, padding = 0.1, 30
        _, _, h, w = x_os8.shape
        m = gaussian_smoothing(x_os8, sigma=3) > thresh
        y_idx = torch.arange(h, device=x_os8.device)
        x_idx = torch.arange(w, device=x_os8.device)
        row_any, col_any = m.any(dim=-1), m.any(dim=-2)              # (N, C, H), (N, C, W)
        big = 10 ** 9
        y_min = torch.where(row_any, y_idx, big).amin(dim=-1)
        y_max = torch.where(row_any, y_idx, -big).amax(dim=-1)
        x_min = torch.where(col_any, x_idx, big).amin(dim=-1)
        x_max = torch.where(col_any, x_idx, -big).amax(dim=-1)
        y_lo = (y_min - padding).clamp(min=0)[..., None]
        y_hi = (y_max + padding).clamp(max=h)[..., None]
        x_lo = (x_min - padding).clamp(min=0)[..., None]
        x_hi = (x_max + padding).clamp(max=w)[..., None]
        ymask = (y_idx >= y_lo) & (y_idx < y_hi)                     # (N, C, H)
        xmask = (x_idx >= x_lo) & (x_idx < x_hi)                     # (N, C, W)
        box = ymask[..., :, None] & xmask[..., None, :]
        nonempty = row_any.any(dim=-1)[..., None, None]
        return torch.where(nonempty, box, True).to(x_os8.dtype)

    def _attend(self, z, masks5, gt_masks, use_mask_atten: bool, mem_feat=None):
        def temp_fn(fm5):
            return self.os8_temp_module.propagate_features(fm5, mem_feat, self.temp_mode)
        return self.refine_OS8(z, masks5, gt_masks, False, aggregate_mem_fn=temp_fn)

    def forward(self, x, mid_fea: dict, b: int, n_f: int, n_i: int, masks,
                gt_alphas=None, use_mask_atten: bool = False, use_gt_guidance: bool = False,
                generator: torch.Generator | None = None,
                mem_feat: torch.Tensor | None = None, spar_gt=None, **_unused) -> dict:
        """x (b*n_f, 512, h32, w32); masks (b*n_f, n_i_in, H, W) guidance masks;
        ``mem_feat`` (b, C, h8, w8): the ConvGRU's state before the first
        frame, or None for a zero state. Train mode takes the image decoder's
        train arguments and ``spar_gt`` (b*n_f, n_i, H, W), the transition GT
        whose slot 0 supervises the change maps, and adds the fused alphas,
        the change maps and the temporal losses (``_train_temporal``); it
        returns no memory."""
        if not self.training:
            return self._eval_forward(x, mid_fea, b, n_f, n_i, masks, mem_feat)
        step = TrainStep(b, n_f, masks, gt_alphas, spar_gt, False, use_gt_guidance, generator,
                         mem_feat)
        return self.train_forward(remat.Stages(), x, mid_fea["shortcut"], step)

    # the JAX video decoder tags neither x_os8_logit nor feat8
    # (maggie_tpu/models/decoder_video.py:154-163): under selective remat the
    # os8 attention and rung 1 are one stage
    tag_os8 = False

    def _train_temporal(self, ret: dict, feat8, step: TrainStep) -> None:
        b, n_f = step.b, step.n_f
        alpha = ret["refined_masks"]
        diff_fwd, diff_bwd, fused = self.bidirectional_fusion(
            feat8.detach().reshape((b, n_f) + feat8.shape[1:]),
            alpha.reshape((b, n_f) + alpha.shape[1:]))
        ret.update(temp_alpha=fused, diff_forward=torch.sigmoid(diff_fwd),
                   diff_backward=torch.sigmoid(diff_bwd))
        if step.spar_gt is not None:
            ret.update(self.loss_temporal_sparsity(diff_fwd, diff_bwd, step.spar_gt, b))

    def _eval_forward(self, x, mid_fea: dict, b: int, n_f: int, n_i: int, masks,
                      mem_feat) -> dict:
        fea1, fea2, fea3, fea4, fea5 = mid_fea["shortcut"]
        h, w = mid_fea["image"].shape[2:]
        sc0 = self._lazy_shortcut(mid_fea)
        masks5 = masks.reshape((b, n_f) + masks.shape[1:])
        z = per_frame(lambda e, f5, f4: self.layer2(self.layer1(e) + f5) + f4, x, fea5, fea4)
        x_os8_logit, feat8, queries, _, hidden = self._attend(z, masks5, None, False, mem_feat)
        x_os8 = resize_bilinear(x_os8_logit[:, :n_i], (h, w), align_corners=False)
        x_os8 = (torch.tanh(x_os8) + 1.0) / 2.0
        unknown_os8 = compute_unknown(x_os8, k_size=30)     # before the snap (:184-188)
        x_os8 = torch.where(x_os8 >= 0.95, 1.0, x_os8)
        box = self._bbox_mask(x_os8)
        unknown_os8 = unknown_os8 * box
        x_os8 = x_os8 * box

        q = queries[:, None].expand((b, n_f) + queries.shape[1:])
        q = q.reshape((b * n_f,) + queries.shape[1:])[:, :n_i]
        if self.sparse_mode == "block":
            x_os4_log, x_os1_log = self.predict_details_block(
                feat8, unknown_os8, q, fea1, fea2, fea3, sc0=sc0)
        else:
            x_os4_log, x_os1_log = self.predict_details(feat8, unknown_os8, q, fea1, fea2, fea3)
        x_os4 = resize_bilinear(x_os4_log.float(), (h, w), align_corners=False)
        x_os4 = (torch.tanh(x_os4) + 1.0) / 2.0
        x_os1 = (torch.tanh(x_os1_log.float()) + 1.0) / 2.0
        alpha, _, _ = self.fuse(x_os1, x_os4, x_os8, unknown_os8)
        ret = {"alpha_os1": x_os1, "alpha_os4": x_os4, "alpha_os8": x_os8,
               "refined_masks": alpha, "detail_mask": unknown_os8}
        if self.use_temp:
            ret["mem_feat"] = hidden
        if self.use_fusion:
            feat_os8 = feat8.reshape((b, n_f) + feat8.shape[1:])
            diff_fwd, diff_bwd, fused = self.bidirectional_fusion(
                feat_os8, alpha.reshape((b, n_f) + alpha.shape[1:]))
            ret.update(temp_alpha=fused, diff_forward=torch.sigmoid(diff_fwd),
                       diff_backward=torch.sigmoid(diff_bwd))
        return ret

    @staticmethod
    def loss_temporal_sparsity(diff_forward, diff_backward, spar_gt, b: int) -> dict:
        """BCE with logits and dtSSD of the change maps against the transition
        GT's slot 0 (reference ``:183-203``): the forward map of frame t and
        the backward map of frame t - 1 are both held to frame t's GT, t >= 1;
        ``loss_temp`` is (BCE + dtSSD forward + dtSSD backward) / 4.
        diff_*: (b, n_f, 1, H, W) logits; spar_gt: (b*n_f, n_i, H, W)."""
        sg = spar_gt.reshape((b, -1) + spar_gt.shape[1:])[:, 1:, 0:1]   # (b, n_f-1, 1, H, W)

        def bce(logits, labels):
            return parallel.global_mean(logits.clamp(min=0) - logits * labels
                                        + torch.log1p(torch.exp(-logits.abs())))
        fwd, bwd = diff_forward[:, 1:], diff_backward[:, :-1]
        bce_sum = bce(fwd[:, :, 0], sg[:, :, 0]) + bce(bwd[:, :, 0], sg[:, :, 0])
        ones = torch.ones_like(sg)
        dt_f = loss_dtssd(torch.sigmoid(fwd), sg, ones)
        dt_b = loss_dtssd(torch.sigmoid(bwd), sg, ones)
        return {"loss_temp_bce": bce_sum, "loss_temp_dtssd": dt_f + dt_b,
                "loss_temp": (bce_sum + dt_f + dt_b) * 0.25}
