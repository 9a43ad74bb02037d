"""GCA-style ResNet-D encoder with shortcut branches and the instance-mask ID
embedding (port of ``maggie_tpu/models/encoder.py``), NCHW.

``ResMaskEmbedShortCutD`` is MaGGIe's encoder (reference ``resnet.py:202-229``).
Its modules sit directly under ``encoder.`` as in the reference's ``state_dict``
(the JAX package nests them under ``backbone``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Embedding, SNConv, res_layer_enc


class ShortcutBlock(nn.Sequential):
    """SNConv3x3 -> ReLU -> BN -> SNConv3x3 -> ReLU -> BN (reference
    ``resnet.py:167-175``; ReLU before BN as there). Keys ``.0, .2, .3, .5``.

    ``inner_mask``: 0/1 inside-image mask applied to the intermediate activation
    when the block runs on gathered patches (the lazy os1 path): beyond the image
    border the dense pipeline's second conv saw zero padding."""

    def __init__(self, in_ch: int, planes: int):
        super().__init__(SNConv(in_ch, planes), nn.ReLU(), BatchNorm(planes),
                         SNConv(planes, planes), nn.ReLU(), BatchNorm(planes))

    def forward(self, x: torch.Tensor, inner_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self[2](F.relu(self[0](x)))
        if inner_mask is not None:
            x = x * inner_mask.to(x.dtype)
        return self[5](F.relu(self[3](x)))


class ResShortCutD(nn.Module):
    """Encoder with shortcut branches (reference ``ResShortCut_D.forward``,
    ``resnet.py:177-200``). Input NCHW with ``in_ch`` channels.

    ``lazy_os1_shortcut`` (eval): skip the dense full-resolution os1 shortcut
    branch; the decoder runs ``shortcut.0`` on gathered patches of the encoder
    input instead (``mid_fea['shortcut0_fn']``, ``['shortcut0_input']``), as the
    JAX package does (``maggie_tpu/models/encoder.py:147-152``). Train mode
    builds the dense branch: its batch statistics span the whole map.

    Train mode also switches every BatchNorm to batch statistics and every
    spectral norm to one power step per forward (``layers.py``)."""

    def __init__(self, in_ch: int, layers=(3, 4, 4, 2), lazy_os1_shortcut: bool = False):
        super().__init__()
        self.lazy_os1_shortcut = lazy_os1_shortcut
        self.conv1 = SNConv(in_ch, 32, 3, 2, 1)
        self.bn1 = BatchNorm(32)
        self.conv2 = SNConv(32, 32, 3, 1, 1)
        self.bn2 = BatchNorm(32)
        self.conv3 = SNConv(32, 64, 3, 2, 1)
        self.bn3 = BatchNorm(64)
        self.layer1 = res_layer_enc(64, 64, layers[0], 1)
        self.layer2 = res_layer_enc(64, 128, layers[1], 2)
        self.layer3 = res_layer_enc(128, 256, layers[2], 2)
        self.layer_bottleneck = res_layer_enc(256, 512, layers[3], 2)
        self.shortcut = nn.ModuleList([
            ShortcutBlock(in_ch, 32), ShortcutBlock(32, 32), ShortcutBlock(64, 64),
            ShortcutBlock(128, 128), ShortcutBlock(256, 256)])

    def backbone(self, inp: torch.Tensor):
        out = F.relu(self.bn1(self.conv1(inp)))
        x1 = F.relu(self.bn2(self.conv2(out)))
        out = F.relu(self.bn3(self.conv3(x1)))
        x2 = self.layer1(out)
        x3 = self.layer2(x2)
        x4 = self.layer3(x3)
        out = self.layer_bottleneck(x4)
        mid_fea = {}
        if self.lazy_os1_shortcut and not self.training:
            fea1 = None
            mid_fea["shortcut0_fn"] = self.shortcut[0]
            mid_fea["shortcut0_input"] = inp
        else:
            fea1 = self.shortcut[0](inp)
        fea2 = self.shortcut[1](x1)
        fea3 = self.shortcut[2](x2)
        fea4 = self.shortcut[3](x3)
        fea5 = self.shortcut[4](x4)
        mid_fea.update({"shortcut": (fea1, fea2, fea3, fea4, fea5),
                        "image": inp[:, :3],
                        "backbone_feat": (x2, x3, x4, out)})
        return out, mid_fea

    def forward(self, x: torch.Tensor):
        return self.backbone(x)


class ResMaskEmbedShortCutD(ResShortCutD):
    """MaGGIe encoder (reference ``ResMaskEmbedShortCut_D``, ``resnet.py:202-229``).

    Input NCHW with channels [RGB | num_mask binary instance masks]. The masks
    are painted with instance IDs, embedded by a (num_mask+1, num_embed) table,
    and the masked mean over instances is concatenated to RGB. For 0/1 masks the
    reference's ID gather and masked mean reduce to a linear map:
    sum_j m_j * table[j+1] / (sum_j m_j + 1e-6), one small matmul
    (``maggie_tpu/models/encoder.py:218-236``)."""

    def __init__(self, layers=(3, 4, 4, 2), num_mask: int = 10, num_embed: int = 3,
                 lazy_os1_shortcut: bool = False):
        super().__init__(3 + num_embed, layers, lazy_os1_shortcut)
        self.num_embed = num_embed
        self.mask_embed_layer = Embedding(num_mask + 1, num_embed)

    def forward(self, x: torch.Tensor):
        inp = x[:, :3]
        masks = x[:, 3:]                                   # (N, n_m, H, W), 0/1
        n_m = masks.shape[1]
        m = (masks > 0.5).float()
        emb = torch.einsum("nmhw,me->nehw", m, self.mask_embed_layer.weight[1:n_m + 1].float())
        emb = emb / (m.sum(dim=1, keepdim=True) + 1e-6)
        return self.backbone(torch.cat([inp, emb.to(inp.dtype)], dim=1))
