"""The MGM baseline decoder ``ResShortCutDec`` (``res_shortcut_22``), NCHW
(port of ``maggie_tpu/models/decoder_dense.py``; reference
``ResShortCut_D_Dec``, ``decoder/resnet.py:163-199``).

It upsamples os32 -> os1 through four residual decoder layers with the
encoder's skip features added; three conv heads give the os8, os4 and os1
alphas, (tanh + 1) / 2 of the logits, os8 and os4 bilinearly upsampled to
full size (align_corners False) after a cast to f32 (``:78-79``). It has no
fusion of its own: the arch fuses (``MaGGIe.fuse``: K2 at k=30, then k=15,
in eval; random-width dilations in train).

In eval a batch of several frames is decoded one frame at a time
(``layers.per_frame``'s reasons: cuDNN's algorithm choice at batch 3 with
TF32 off, and a frame's result that does not depend on its batch); train
mode needs the whole batch for BatchNorm's statistics. Train mode
(``train_forward``) runs the decoder as one stage and hands its alphas to
the arch's losses (``TrainStep.finish``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import BatchNorm, Conv2d, SNConvTranspose, leaky_relu, per_frame, res_layer_dec
from ..ops.resize import resize_bilinear

_KEYS = ("alpha_os1", "alpha_os4", "alpha_os8")


class RefineHead(nn.Sequential):
    """conv(k) -> BN -> LeakyReLU(0.2) -> conv(k) (reference ``resnet.py:74-91``);
    keys ``.0``, ``.1``, ``.3``."""

    def __init__(self, in_ch: int, mid: int = 32, out: int = 1, kernel: int = 3):
        super().__init__(Conv2d(in_ch, mid, kernel, 1, kernel // 2, bias=False), BatchNorm(mid),
                         nn.LeakyReLU(0.2), Conv2d(mid, out, kernel, 1, kernel // 2))


class ResShortCutDec(nn.Module):
    """MGM decoder (``res_shortcut_22``); ``cast_f32``: the heads in f32
    (the FAM decoder keeps the activation dtype)."""

    cast_f32 = True

    def __init__(self, layers=(2, 3, 3, 2), max_inst: int = 1, large_kernel: bool = False,
                 late_downsample: bool = False, **_unused):
        super().__init__()
        k = 5 if large_kernel else 3
        midplanes = 64 if late_downsample else 32
        self.layer1 = res_layer_dec(512, 256, layers[0], 2)
        self.layer2 = res_layer_dec(256, 128, layers[1], 2)
        self.layer3 = res_layer_dec(128, 64, layers[2], 2)
        self.layer4 = res_layer_dec(64, midplanes, layers[3], 2)
        self.conv1 = SNConvTranspose(midplanes, 32)
        self.bn1 = BatchNorm(32)
        self.refine_OS1 = RefineHead(32, 32, max_inst, k)
        self.refine_OS4 = RefineHead(64, 32, max_inst, k)
        self.refine_OS8 = RefineHead(128, 32, max_inst, k)

    def _os8(self, x, fea5, fea4):
        x = self.layer1(x) + fea5
        return self.layer2(x) + fea4

    def _from_os8(self, x, fea3, fea2, fea1):
        """The three heads from the os8 features, as alphas at full size."""
        x_os8 = self.refine_OS8(x)
        x = self.layer3(x) + fea3
        x_os4 = self.refine_OS4(x)
        x = self.layer4(x) + fea2
        x = leaky_relu(self.bn1(self.conv1(x))) + fea1
        x_os1 = self.refine_OS1(x)
        size = x_os1.shape[-2:]
        cast = (lambda t: t.float()) if self.cast_f32 else (lambda t: t)
        alpha = lambda t: (torch.tanh(t) + 1.0) / 2.0
        return (alpha(cast(x_os1)),
                alpha(resize_bilinear(cast(x_os4), size, align_corners=False)),
                alpha(resize_bilinear(cast(x_os8), size, align_corners=False)))

    def _decode(self, x, fea1, fea2, fea3, fea4, fea5):
        return self._from_os8(self._os8(x, fea5, fea4), fea3, fea2, fea1)

    def _frames(self, fn, *ts):
        """``fn(*ts)``; in eval a frame at a time (``per_frame``)."""
        return fn(*ts) if self.training else per_frame(fn, *ts)

    def forward(self, x, mid_fea, **_unused) -> dict:
        """x (N, 512, H/32, W/32), ``mid_fea['shortcut']`` the encoder's
        fea1 to fea5 -> {alpha_os1, alpha_os4, alpha_os8}, (N, max_inst, H, W)."""
        return dict(zip(_KEYS, self._frames(self._decode, x, *mid_fea["shortcut"])))

    def train_forward(self, run, x, feas, step):
        """The train forward from the ASPP output ``x`` and the encoder's
        ``feas`` (fea1 to fea5) as one stage through ``run``, ending in the
        arch's losses (``step.finish``)."""
        return run(self._train_stage, x, *feas, step)

    def _train_stage(self, x, fea1, fea2, fea3, fea4, fea5, step):
        pred = dict(zip(_KEYS, self._decode(x, fea1, fea2, fea3, fea4, fea5)))
        return pred if step.finish is None else step.finish(pred)
