"""LPN, SparseMat's low-resolution prediction network (port of
``maggie_tpu/models/lpn.py``; reference ``maggie/network/encoder/lpn.py``),
NCHW: a MobileNetV2 backbone and a MODNet-style decoder (``HLBranch``) with
an SE block on the deepest features. Returns the fused sigmoid alpha at the
input's size and the 1/16 context features ``dec16x``.

Every resize is bilinear with ``align_corners=False``. ``IBNorm``,
BatchNorm and the instance norm compute in f32 and return the input dtype,
as the port's BatchNorm does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d, Linear
from .mobilenetv2 import MobileNetV2Backbone
from ..ops.resize import resize_bilinear


def _upsample_like(src: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(src, tar.shape[-2:])


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


class IBNorm(nn.Module):
    """BatchNorm on the first half of the channels, instance norm without
    affine on the rest (biased variance, ``rsqrt(var + 1e-5)``)
    (reference ``lpn.py:13-33``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.half = channels // 2
        self.bnorm = BatchNorm(self.half)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bnorm(x[:, :self.half])
        inx = x[:, self.half:].float()
        var, mean = torch.var_mean(inx, dim=(2, 3), keepdim=True, correction=0)
        return torch.cat([bn, ((inx - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)], dim=1)


class ConvIBNRelu(nn.Module):
    """conv (with bias) -> IBNorm -> ReLU, either of the last two optional."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, with_ibn: bool = True, with_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride, padding)
        self.ibn = IBNorm(out_ch) if with_ibn else None
        self.with_relu = with_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.ibn is not None:
            x = self.ibn(x)
        return F.relu(x) if self.with_relu else x


def _head(in_ch: int) -> ConvIBNRelu:
    """A 1x1 logit head: conv only."""
    return ConvIBNRelu(in_ch, 1, 1, with_ibn=False, with_relu=False)


class SEBlock(nn.Module):
    """Squeeze and excitation: spatial mean, two bias-free linears (ReLU,
    sigmoid), channel gate."""

    def __init__(self, channels: int, out_channels: int, reduction: int = 1):
        super().__init__()
        self.fc1 = Linear(channels, channels // reduction, bias=False)
        self.fc2 = Linear(channels // reduction, out_channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * w[:, :, None, None]


class HLBranch(nn.Module):
    """MODNet high-level branch (reference ``lpn.py:86-160``) on the
    backbone's five taps (16, 24, 32, 96, 1280 channels)."""

    def __init__(self, in_ch: int, hr: int, enc=(16, 24, 32, 96, 1280)):
        super().__init__()
        e2, e4, e8, e16, e32 = enc
        block = lambda i, o: ConvIBNRelu(i, o, 3, padding=1)
        self.se_block = SEBlock(e32, e32, reduction=4)
        self.p32x = _head(e32)
        self.conv_dec16x_0 = block(e32 + e16, 2 * hr)
        self.conv_dec16x_1 = block(2 * hr, hr)
        self.p16x = _head(hr + 1)
        self.conv_dec8x_0 = block(hr + e8, 2 * hr)
        self.conv_dec8x_1 = block(2 * hr, hr)
        self.p8x = _head(hr + 1)
        self.conv_dec4x_0 = block(hr + e4, 2 * hr)
        self.conv_dec4x_1 = block(2 * hr, hr)
        self.p4x = _head(hr)
        self.conv_dec2x_0 = block(hr + e2, 2 * hr)
        self.conv_dec2x_1 = block(2 * hr, hr)
        self.conv_dec2x_2 = block(hr, hr)
        self.p2x = _head(hr + 1)
        self.conv_dec1x_0 = block(hr + in_ch, hr)
        self.p1x = _head(hr + 1)
        self.p0x = _head(2)

    def forward(self, img, enc2x, enc4x, enc8x, enc16x, enc32x):
        cat = lambda *t: torch.cat(t, dim=1)
        enc32x = self.se_block(enc32x)
        p32x = _upsample_like(self.p32x(enc32x), img)

        dec16x = self.conv_dec16x_1(self.conv_dec16x_0(cat(_up2(enc32x), enc16x)))
        p16x = _upsample_like(self.p16x(cat(dec16x, _upsample_like(p32x, dec16x))), img)

        dec8x = self.conv_dec8x_1(self.conv_dec8x_0(cat(_up2(dec16x), enc8x)))
        p8x = _upsample_like(self.p8x(cat(dec8x, _upsample_like(p16x, dec8x))), img)

        dec4x = self.conv_dec4x_1(self.conv_dec4x_0(cat(_up2(dec8x), enc4x)))
        p4x = _upsample_like(self.p4x(dec4x), img)

        dec2x = self.conv_dec2x_0(cat(_up2(dec4x), enc2x))
        dec2x = self.conv_dec2x_2(self.conv_dec2x_1(dec2x))
        p2x = _upsample_like(self.p2x(cat(dec2x, _upsample_like(p4x, dec2x))), img)

        dec1x = self.conv_dec1x_0(cat(_up2(dec2x), img))
        p1x = self.p1x(cat(dec1x, _upsample_like(p2x, dec1x)))
        p0x = self.p0x(cat(p1x, _upsample_like(p8x, p1x)))
        return torch.sigmoid(p0x), dec16x


class LPN(nn.Module):
    """Reference ``LPN`` (lpn.py:196-206): (sigmoid alpha at the input's
    size, dec16x context) of an (N, in_ch, h, w) input."""

    def __init__(self, in_ch: int = 4, mid_chn: int = 32):
        super().__init__()
        self.backbone = MobileNetV2Backbone(in_ch)
        self.decoder = HLBranch(in_ch, mid_chn)

    def forward(self, images: torch.Tensor):
        return self.decoder(images, *self.backbone(images))
