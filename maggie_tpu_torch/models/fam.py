"""TCVOM's feature aggregation module, NCHW (port of
``maggie_tpu/models/fam.py``; reference ``maggie/network/module/fam.py``).

Each os8 query position attends over the 9x9 window of the previous and of
the next frame's key features. The reference gathers the positions of the
unknown band with a per-sample Python loop (``fam.py:25-53``); as in the JAX
package, attention runs at every position and is zeroed off the band, which
gives the band the same values.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d
from ..ops.resize import resize_nearest


def unfold_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, window*window, H, W): each position's zero-padded
    neighbourhood, window offsets in row-major order (the JAX package's
    ``unfold_nhwc``, ``:22-30``, with the channels first)."""
    n, c, h, w = x.shape
    return F.unfold(x, window, padding=window // 2).reshape(n, c, window * window, h, w)


class FeatureAggregationModule(nn.Module):
    """``forward(x, b_feat, f_feat, mask)``: x and the neighbours' features
    (B, C, H, W), ``mask`` (B, 1, 8H, 8W) the unknown band. Returns the
    aggregated features ``value(x) + att_b + att_f``, the attention logits
    ``attb``/``attf`` (B, window**2, H*W) zeroed off the band (the loss's
    input), and the band at (H, W). The softmax reads the logits before the
    band is applied (``:59-60``)."""

    def __init__(self, input_chn: int = 128, reduction: int = 1, window: int = 9):
        super().__init__()
        out = input_chn // reduction
        self.window = window
        self.key_conv = Conv2d(input_chn, out, 3, 1, 1)
        self.query_conv = Conv2d(input_chn, out, 3, 1, 1)
        self.value_conv = Conv2d(input_chn, out, 3, 1, 1)

    def forward(self, x, b_feat, f_feat, mask):
        b, _, h, w = x.shape
        m = resize_nearest(mask, (h, w))                               # (B, 1, H, W)
        q = self.query_conv(x)
        scale = math.sqrt(q.shape[1])

        def attention(target):
            k = unfold_windows(self.key_conv(target), self.window)     # (B, C, K, H, W)
            qdotk = (q[:, :, None] * k).sum(1) / scale                 # (B, K, H, W)
            att = torch.softmax(qdotk.float(), dim=1).to(k.dtype)
            atted = (att[:, None] * k).sum(2) * m.to(k.dtype)
            return atted, (qdotk * m).reshape(b, -1, h * w)

        xb, attb = attention(b_feat)
        xf, attf = attention(f_feat)
        return self.value_conv(x) + xb + xf, attb, attf, m
