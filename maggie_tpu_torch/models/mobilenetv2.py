"""MobileNetV2 backbone of SparseMat's LPN (port of
``maggie_tpu/models/mobilenetv2.py``; reference
``maggie/network/encoder/mobilenetv2.py``), NCHW.

``features`` holds the stem ``ConvBN(32, s2)``, the 17 inverted residual
blocks and the last ``ConvBN(1280, 1x1)``; the forward taps the outputs of
blocks 1, 3, 6 and 13 and of the last ConvBN (enc2x, enc4x, enc8x, enc16x,
enc32x: 16, 24, 32, 96 and 1280 channels).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d

_TAPS = (1, 3, 6, 13)


def _make_divisible(v, divisor: int = 8, min_value: int | None = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def relu6(x: torch.Tensor) -> torch.Tensor:
    return F.hardtanh(x, 0.0, 6.0)


class ConvBN(nn.Module):
    """conv (no bias; 3x3 pads 1, 1x1 pads 0) -> BN -> relu6."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, 1 if kernel == 3 else 0, bias=False)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return relu6(self.bn(self.conv(x)))


class InvertedResidual(nn.Module):
    """Reference ``InvertedResidual`` (mobilenetv2.py:58-116), with norms:
    1x1 expansion (when ``expansion`` != 1), 3x3 depthwise at ``stride``,
    1x1 linear projection; the input added back where the shape allows."""

    def __init__(self, inp: int, oup: int, stride: int, expansion: int):
        super().__init__()
        hidden = round(inp * expansion)
        self.use_res = stride == 1 and inp == oup
        self.expand = expansion != 1
        if self.expand:
            self.pw = Conv2d(inp, hidden, 1, 1, 0, bias=False)
            self.pw_bn = BatchNorm(hidden)
        self.dw = Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False)
        self.dw_bn = BatchNorm(hidden)
        self.pw_linear = Conv2d(hidden, oup, 1, 1, 0, bias=False)
        self.pw_linear_bn = BatchNorm(oup)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = relu6(self.pw_bn(self.pw(x))) if self.expand else x
        y = relu6(self.dw_bn(self.dw(y)))
        y = self.pw_linear_bn(self.pw_linear(y))
        return x + y if self.use_res else y


class MobileNetV2Backbone(nn.Module):
    def __init__(self, in_ch: int, alpha: float = 1.0, expansion: int = 6):
        super().__init__()
        setting = [(1, 16, 1, 1), (expansion, 24, 2, 2), (expansion, 32, 3, 2),
                   (expansion, 64, 4, 2), (expansion, 96, 3, 1), (expansion, 160, 3, 2),
                   (expansion, 320, 1, 1)]
        ch = _make_divisible(32 * alpha)
        layers = [ConvBN(in_ch, ch, 3, 2)]
        for t, c, n, s in setting:
            out_ch = _make_divisible(int(c * alpha))
            for i in range(n):
                layers.append(InvertedResidual(ch, out_ch, s if i == 0 else 1, t))
                ch = out_ch
        layers.append(ConvBN(ch, 1280, 1, 1))
        self.features = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _TAPS:
                feats.append(x)
        feats.append(x)
        return feats
