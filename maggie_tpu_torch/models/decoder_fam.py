"""TCVOM's decoder ``ResShortCutFAMDec`` (``res_shortcut_fam_22``), NCHW (port
of ``maggie_tpu/models/decoder_fam.py``; reference ``decoder/resnet_fam.py``):
the MGM decoder (``decoder_dense.py``) with the feature aggregation module
(``fam.py``) after ``layer2`` on a pass that is given the neighbour frames'
features. Unlike the MGM decoder it keeps its heads in the activation dtype
(``:59-64``).

In train mode the BatchNorms of ``layer1`` and ``layer2`` normalize with
their running statistics and do not update them (reference ``train()``
override, ``resnet_fam.py:12-16``), while their spectral norms still step.
"""

from __future__ import annotations

from .decoder_dense import _KEYS, ResShortCutDec
from .fam import FeatureAggregationModule
from .layers import BatchNorm


class ResShortCutFAMDec(ResShortCutDec):
    cast_f32 = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.fam = FeatureAggregationModule(128, 1, 9)

    def train(self, mode: bool = True):
        super().train(mode)
        for layer in (self.layer1, self.layer2):
            for m in layer.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, x, shortcuts, xb=None, xf=None, mask=None, **_unused):
        """x (N, 512, H/32, W/32); ``shortcuts`` the encoder's fea1 to fea5;
        ``xb``/``xf`` the previous and the next frame's os8 features and
        ``mask`` (N, 1, H, W) the unknown band, or None for a pass without
        the FAM. Returns ``(pred, features, attb, attf, mask)``: the three
        alphas, the os8 features before the FAM, and the FAM's attention
        logits and band at os8 (None without the FAM)."""
        fea1, fea2, fea3, fea4, fea5 = shortcuts
        features = self._frames(self._os8, x, fea5, fea4)
        z, attb, attf = features, None, None
        if xb is not None:
            z, attb, attf, mask = self.fam(features, xb, xf, mask)
        pred = dict(zip(_KEYS, self._frames(self._from_os8, z, fea3, fea2, fea1)))
        return pred, features, attb, attf, mask
