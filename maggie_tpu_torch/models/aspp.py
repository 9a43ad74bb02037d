"""ASPP (port of ``maggie_tpu/models/aspp.py``; reference ``module/aspp.py:8-57``):
DeepLab atrous pyramid with dilations 1, 2, 4, 8 and a global-pool branch, NCHW."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d


class ASPP(nn.Module):
    def __init__(self, in_channels: int = 512, out_channels: int = 512, mid_channels: int = 256):
        super().__init__()
        m = mid_channels
        self.aspp1 = Conv2d(in_channels, m, 1, bias=False)
        self.aspp1_bn = BatchNorm(m)
        for i, d in ((2, 2), (3, 4), (4, 8)):
            setattr(self, f"aspp{i}", Conv2d(in_channels, m, 3, padding=d, dilation=d, bias=False))
            setattr(self, f"aspp{i}_bn", BatchNorm(m))
        self.aspp5 = Conv2d(in_channels, m, 1, bias=False)
        self.aspp5_bn = BatchNorm(m)
        self.conv2 = Conv2d(5 * m, out_channels, 1, bias=False)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [F.relu(getattr(self, f"aspp{i}_bn")(getattr(self, f"aspp{i}")(x)))
              for i in range(1, 5)]
        # global branch: AdaptiveAvgPool2d(1) -> 1x1 conv -> BN -> ReLU -> broadcast
        g = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        g = F.relu(self.aspp5_bn(self.aspp5(g)))
        ys.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return F.relu(self.bn2(self.conv2(torch.cat(ys, dim=1))))
