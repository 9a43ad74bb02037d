"""Convolutional GRU, the video model's temporal feature memory (port of
``maggie_tpu/models/conv_gru.py``; reference ``network/module/conv_gru.py``),
NCHW. The reference's ``ih`` and ``hh`` are ``Sequential(conv, activation)``,
so the state-dict keys are ``ih.0.*`` and ``hh.0.*``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv2d


class ConvGRU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.ih = nn.Sequential(Conv2d(channels * 2, channels * 2, 3, padding=1), nn.Sigmoid())
        self.hh = nn.Sequential(Conv2d(channels * 2, channels, 3, padding=1), nn.Tanh())

    def step(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        r, z = self.ih(torch.cat([x, h], dim=1)).chunk(2, dim=1)
        c = self.hh(torch.cat([x, r * h], dim=1))
        return (1 - z) * h + z * c

    def forward(self, x: torch.Tensor, h: torch.Tensor | None = None):
        """x: (b, n_f, c, h, w) series or (b, c, h, w) frame. Returns (outputs,
        hidden); for a series ``hidden`` stacks every step's state (reference
        ``forward_time_series``, conv_gru.py:26-38)."""
        if x.dim() == 4:
            hn = self.step(x, torch.zeros_like(x) if h is None else h)
            return hn, hn
        if h is None:
            h = x.new_zeros(x.shape[:1] + x.shape[2:])
        hs = []
        for t in range(x.shape[1]):
            h = self.step(x[:, t], h)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        return hs, hs

    def propagate_features(self, feat: torch.Tensor, prev_h_state: torch.Tensor | None = None,
                           temp_method: str = "none"):
        """Reference ``propagate_features`` (conv_gru.py:50-69) over feat
        (b, n_f, c, h, w): ``none`` runs each frame from a zero state;
        ``forward`` runs the series from ``prev_h_state``; ``bi`` then runs
        back over frames n_f-2..0 from the forward pass's last state and
        averages both directions there. Returns (features, hidden state)."""
        n_f = feat.shape[1]
        if temp_method == "none":
            outs = [self(feat[:, j])[0] for j in range(n_f)]
            return torch.stack(outs, dim=1), outs[-1]
        feat_fwd, hidden = self(feat, prev_h_state)
        if temp_method != "bi" or n_f == 1:
            return feat_fwd, hidden
        feat_bwd, _ = self(feat[:, :-1].flip(1), hidden[:, -1])
        head = (feat_fwd[:, :-1] + feat_bwd.flip(1)) / 2
        return torch.cat([head, feat_fwd[:, -1:]], dim=1), hidden
