"""SHM, SparseMat's sparse refinement module (port of
``maggie_tpu/models/shm.py``; reference ``decoder/shm.py`` and
``decoder/sparse_resnet_bn.py``), in the dense-masked form of
``sparse_layers.py``, NCHW with 0/1 masks (N, 1, H, W).

A sparse ResNet-18 runs over the active pixels of [RGB | normalized lr_pred]
(4 channels); ``SparseCAM``'s global foreground/background context gates
its bottleneck; three inverse convs, each back to the active set of the
conv it inverts, and a 3-conv alpha head emit four sigmoid alphas times
their masks. The active sets follow spconv's ``indice_key`` pairing:
m1 --conv2 (s2)--> m2 --layer1 (s2)--> m4 --layer2 (s2)--> m8; layer3 and
layer4 are submanifold on m8, layer4's first conv with dilation 2.

Convolution weights keep spconv 2's (O, kh, kw, I) layout (``_SpconvWeight``),
the context gate's three 1x1 convs torch's (O, I, 1, 1).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d
from .sparse_layers import (MaskedBatchNorm, SparseInverseConv, SubMConv, _SpconvWeight,
                            active_mask_downsample)
from ..ops.resize import resize_bilinear


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class StridedSparseConv(_SpconvWeight):
    """k=3, s=2, p=1 sparse conv: its active set is every coarse site whose
    window touches an active fine site (``active_mask_downsample``).
    Returns the output and that set."""

    def __init__(self, in_ch: int, out_ch: int, bias: bool = False):
        super().__init__(in_ch, out_ch, 3, bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        w = self.weight.permute(0, 3, 1, 2).to(x.dtype)
        y = self._bias(F.conv2d(x * mask.to(x.dtype), w, stride=2, padding=1))
        m_out = active_mask_downsample(mask)
        return y * m_out.to(y.dtype), m_out


class SparseBasicBlock(nn.Module):
    """sparse_resnet_bn ``BasicBlock`` (``:40-75``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.stride = stride
        if stride == 2:
            self.conv1 = StridedSparseConv(inplanes, planes)
        else:
            self.conv1 = SubMConv(inplanes, planes, 3, False, dilation)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes, 3, True)
        self.bn2 = MaskedBatchNorm(planes)
        if has_downsample:
            self.downsample_conv = (StridedSparseConv(inplanes, planes) if stride == 2
                                    else SubMConv(inplanes, planes, 3, False))
            self.downsample_bn = MaskedBatchNorm(planes)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        if self.stride == 2:
            out, m_out = self.conv1(x, mask)
        else:
            out, m_out = self.conv1(x, mask), mask
        out = F.relu(self.bn1(out, m_out))
        out = self.bn2(self.conv2(out, m_out), m_out)
        if self.downsample_conv is not None:
            res = self.downsample_conv(x, mask)
            res = self.downsample_bn(res[0] if self.stride == 2 else res, m_out)
        else:
            res = x
        return F.relu(out + res) * m_out.to(out.dtype), m_out


def _layer(inplanes: int, planes: int, stride: int, dilation: int) -> nn.ModuleList:
    """Two blocks; the first changes width (and stride or dilation)."""
    return nn.ModuleList([SparseBasicBlock(inplanes, planes, stride, dilation, True),
                          SparseBasicBlock(planes, planes)])


class SparseResNet18(nn.Module):
    """Reference ``SparseResNet18`` (sparse_resnet_bn.py:121-200), stride 8:
    layer1 and layer2 stride 2, layer3 stride 1, layer4 stride 1 with
    dilation 2. Returns the five (features, mask) taps."""

    def __init__(self, in_ch: int = 4):
        super().__init__()
        self.conv1 = SubMConv(in_ch, 64, 3, False)
        self.bn1 = MaskedBatchNorm(64)
        self.conv2 = StridedSparseConv(64, 64)
        self.bn2 = MaskedBatchNorm(64)
        self.conv3 = SubMConv(64, 64, 3, False)
        self.bn3 = MaskedBatchNorm(64)
        self.layer1 = _layer(64, 64, 2, 1)
        self.layer2 = _layer(64, 128, 2, 1)
        self.layer3 = _layer(128, 256, 1, 1)
        self.layer4 = _layer(256, 512, 1, 2)

    def forward(self, x: torch.Tensor, m1: torch.Tensor) -> list:
        z = F.relu(self.bn1(self.conv1(x, m1), m1))
        z, m2 = self.conv2(z, m1)
        z = F.relu(self.bn2(z, m2))
        z = F.relu(self.bn3(self.conv3(z, m2), m2))
        outs, m = [(z, m2)], m2
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in layer:
                z, m = block(z, m)
            outs.append((z, m))
        return outs


class SparseCAM(nn.Module):
    """Global foreground/background context gating (reference
    ``decoder/shm.py:56-76``): the context's means under the low-resolution
    alpha and under its complement, through two 1x1 convs, gate the
    bottleneck's channels."""

    def __init__(self, local_inc: int = 512, global_inc: int = 32):
        super().__init__()
        self.conv_f = Conv2d(global_inc, global_inc, 1)
        self.conv_b = Conv2d(global_inc, global_inc, 1)
        self.conv_g = Conv2d(2 * global_inc, local_inc, 1)

    def forward(self, x, mask_active, ctx, lr_pred):
        mask_lr = resize_bilinear(lr_pred, ctx.shape[-2:])
        ctx = ctx.float()
        fg = F.relu(self.conv_f((ctx * mask_lr).mean(dim=(2, 3), keepdim=True)))
        bg = F.relu(self.conv_b((ctx * (1 - mask_lr)).mean(dim=(2, 3), keepdim=True)))
        w = torch.sigmoid(self.conv_g(torch.cat([fg, bg], dim=1)))
        return x * w.to(x.dtype) * mask_active.to(x.dtype)


class SparseDecoder3_18(nn.Module):
    """Inverse-conv decoder with four sigmoid heads (reference
    ``decoder/shm.py:84-148``): [p4 at m4, p2 at m2, p1 at m1, p0 at m1],
    each f32 and zero off its active set."""

    def __init__(self):
        super().__init__()
        self.conv_up1 = SparseInverseConv(512, 256, 3, True)
        self.conv_up1_bn = MaskedBatchNorm(256)
        self.conv_p8x = SubMConv(256, 1, 1, False)
        self.conv_up2 = SparseInverseConv(256 + 64, 256, 3, True)
        self.conv_up2_bn = MaskedBatchNorm(256)
        self.conv_p4x = SubMConv(256, 1, 1, False)
        self.conv_up3 = SparseInverseConv(256 + 64, 64, 3, True)
        self.conv_up3_bn = MaskedBatchNorm(64)
        self.conv_p2x = SubMConv(64, 1, 1, False)
        self.alpha_conv1 = SubMConv(64 + 3, 32, 3, True)
        self.alpha_conv2 = SubMConv(32, 16, 3, True)
        self.alpha_conv3 = SubMConv(16, 1, 1, False)

    def forward(self, img_feats, m1, conv_out) -> list:
        (x1, m2), (x2, m4), (_, m8), _, (x5, _) = conv_out
        d4 = _lrelu(self.conv_up1_bn(self.conv_up1(x5, m8, m4), m4))
        p4 = self.conv_p8x(d4, m4)
        d2 = self.conv_up2(torch.cat([d4, x2], dim=1), m4, m2)
        d2 = _lrelu(self.conv_up2_bn(d2, m2))
        p2 = self.conv_p4x(d2, m2)
        d1 = self.conv_up3(torch.cat([d2, x1], dim=1), m2, m1)
        d1 = _lrelu(self.conv_up3_bn(d1, m1))
        p1 = self.conv_p2x(d1, m1)
        rgb = (img_feats[:, :3] * 0.5 + 0.5) * m1.to(img_feats.dtype)
        z = _lrelu(self.alpha_conv1(torch.cat([d1, rgb], dim=1), m1))
        z = _lrelu(self.alpha_conv2(z, m1))
        p0 = self.alpha_conv3(z, m1)
        return [torch.sigmoid(p.float()) * m.float()
                for p, m in ((p4, m4), (p2, m2), (p1, m1), (p0, m1))]


class SHM(nn.Module):
    """Reference ``SHM`` (decoder/shm.py:151-166)."""

    def __init__(self, inc: int = 4, ctx_channels: int = 32):
        super().__init__()
        self.backbone = SparseResNet18(inc)
        self.ctx = SparseCAM(512, ctx_channels)
        self.decoder = SparseDecoder3_18()

    def forward(self, sparse_inputs, lr_pred, m1, ctx) -> list:
        """sparse_inputs (N, 4, H, W) masked [RGB | normalized lr_pred];
        lr_pred (N, 1, H, W) f32; m1 (N, 1, H, W) the active set; ctx the
        LPN's (N, 32, H/32, W/32) context at the low resolution's 1/16."""
        feats = self.backbone(sparse_inputs, m1)
        x5, m8 = feats[-1]
        feats[-1] = (self.ctx(x5, m8, ctx, lr_pred), m8)
        return self.decoder(sparse_inputs, m1, feats)
