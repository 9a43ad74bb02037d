"""Masked-dense equivalents of the spconv layers of the MaGGIe detail decoder.

Port of ``maggie_tpu/models/sparse_layers.py`` (eval), NCHW with 0/1 masks
(N, 1, H, W):

- a submanifold conv is ``conv(x * m) * m``;
- a stride-2 sparse conv activates every coarse site whose window touches an
  active fine site: ``max_pool2d(k=3, s=2, p=1)``;
- a sparse inverse conv is a k=3, s=2, p=1, output_padding=1 transposed conv
  masked by the stored fine active set;
- eval BatchNorm1d over sparse features normalizes with running statistics.

Weights keep spconv 2's (O, kh, kw, I) layout under the reference's keys
(``decoder.layer3.0.weight``), so a released checkpoint's tensors map by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import remat
from .. import parallel
from ..parallel import space
from .layers import BatchNorm, xavier_


def active_mask_downsample(mask: torch.Tensor) -> torch.Tensor:
    """Active-set transfer of a k=3 s=2 p=1 sparse conv (padding never wins:
    ``max_pool2d`` pads with -inf, as the JAX ``reduce_window`` does). On a
    band of a row-sharded frame the window's row above comes from the
    neighbour (zeros beyond the frame never win over a 0/1 map either)."""
    x, padding = space.conv_rows(mask, 1)
    return F.max_pool2d(x, 3, 2, padding)


def active_pyramid(m1: torch.Tensor):
    """(m1, m2, m4, m8) active masks (reference ``dummy_downscale`` index books,
    ``resnet_inst_matt_spconv.py:61-66,217-218``)."""
    m2 = active_mask_downsample(m1)
    m4 = active_mask_downsample(m2)
    m8 = active_mask_downsample(m4)
    return m1, m2, m4, m8


class _SpconvWeight(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, k, k, in_ch))  # spconv 2 (O,kh,kw,I)
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        self.k = k

    def init_params(self, g: torch.Generator) -> None:
        o, kh, kw, i = self.weight.shape
        xavier_(self.weight, i * kh * kw, o * kh * kw, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]


class SubMConv(_SpconvWeight):
    """Submanifold conv: conv over masked input, output masked to the active
    set; ``dilation`` d pads d * (k // 2) (SparseMat's layer4)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool, dilation: int = 1):
        super().__init__(in_ch, out_ch, k, bias)
        self.dilation = dilation

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask.to(x.dtype)
        w = self.weight.permute(0, 3, 1, 2).to(x.dtype)       # (O, I, kh, kw)
        d = self.dilation
        y = self._bias(F.conv2d(x * m, w, padding=d * (self.k // 2), dilation=d))
        return y * m


class SparseInverseConv(_SpconvWeight):
    """Inverse of a paired k=3 s=2 p=1 sparse conv: coarse -> stored fine active set.

    The JAX package writes it as an lhs-dilated correlation with the spatially
    flipped HWIO kernel, padding (1, 2) (``maggie_tpu/models/sparse_layers.py:89-105``).
    That is exactly ``conv_transpose2d(stride=2, padding=1, output_padding=1)``
    with the unflipped kernel in (I, O, kh, kw) layout: the transposed conv does
    the flip itself. The output is 2x the coarse size, masked by the fine set."""

    def forward(self, x_coarse: torch.Tensor, mask_coarse: torch.Tensor,
                mask_fine: torch.Tensor) -> torch.Tensor:
        xm = x_coarse * mask_coarse.to(x_coarse.dtype)
        w = self.weight.permute(3, 0, 1, 2).to(xm.dtype)      # (I, O, kh, kw)
        y = self._bias(F.conv_transpose2d(xm, w, stride=2, padding=1, output_padding=1))
        return y * mask_fine.to(y.dtype)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm1d over sparse features (eps 1e-5, momentum 0.1), output masked
    to the active set. Keys as the reference's BatchNorm1d.

    Eval: the dense eval BatchNorm (f32 compute, running statistics). Train
    (``maggie_tpu/models/sparse_layers.py:106-147``): statistics over the
    active sites only, the sites of ``stats_mask`` when given (the block
    ladder passes the halo-free cores of valid blocks, so that each active
    site counts once) and of ``mask`` otherwise; biased variance to
    normalize, unbiased (count / (count - 1)) for the running estimate,
    which a remat recompute does not step.

    Under data parallelism the statistics are the global batch's, in the
    JAX package's two passes: the masked sums and the counts are all-reduced
    first and divided (a rank may hold no active site, and counts differ
    per rank, so per-rank means are never averaged), then the masked squared
    deviations from that global mean; the running variance's correction
    takes the global count. Under row sharding each block runs on the rank
    whose band holds its core, so every rank's sums join."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                stats_mask: torch.Tensor | None = None) -> torch.Tensor:
        if not self.training:
            return super().forward(x) * mask.to(x.dtype)
        m = (mask if stats_mask is None else stats_mask).float()
        xf = x.float()
        if parallel.world() == 1:
            count = torch.clamp(m.sum(), min=1.0)
            mean = (xf * m).sum(dim=(0, 2, 3)) / count
            var = ((xf - mean[:, None, None]) ** 2 * m).sum(dim=(0, 2, 3)) / count
        else:
            sums = parallel.all_reduce_sum(torch.cat([(xf * m).sum(dim=(0, 2, 3)),
                                                      m.sum().reshape(1)]))
            count = torch.clamp(sums[-1], min=1.0)
            mean = sums[:-1] / count
            var = parallel.all_reduce_sum(
                ((xf - mean[:, None, None]) ** 2 * m).sum(dim=(0, 2, 3))) / count
        if not remat.replaying():
            with torch.no_grad():
                self._step_stats(mean, var * count / torch.clamp(count - 1.0, min=1.0))
        y = ((xf - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
             * self.weight[:, None, None] + self.bias[:, None, None])
        return (y * mask.float()).to(x.dtype)
