"""MaGGIe detail decoder: instance-query attention at os8 and the sparse
refinement ladder os8 -> os4 -> os2 -> os1 (port of
``maggie_tpu/models/decoder_sparse.py``; reference
``decoder/resnet_inst_matt_spconv.py``), NCHW.

Two forms of the ladder, selected by ``sparse_mode``:

- ``'block'``: the fixed-capacity block-sparse form (``predict_details_block``).
  One block grid (64 os1 = 32 os2 = 16 os4 = 8 os8 pixels) is chosen by active
  mask counts and drives all three rungs; each rung runs the same modules on a
  (cap, C, p, p) stack of haloed patches. The five patch reads per frame go
  through the CUDA gather kernel; the three ``compute_unknown`` calls through
  the CUDA dilation kernel.
- ``'oracle'``: the dense-masked exact form (``predict_details``), against which
  the block form is held: with capacity for every active block both agree.

Train mode (``model.train()``; ``maggie_tpu/models/decoder_sparse.py:489-601``)
keeps the JAX package's train structure: the block ladder gathers every scale's
mask and features on its own (ten gathers, six of them differentiable, through
the gather kernel and its backward kernel) and hands each rung to the next
through a dense buffer; its BatchNorm statistics cover the halo-free cores of
valid blocks. The os8 alphas are gated by the valid masks, the GT alphas may
guide the uncertainty map (and do when the prediction is all zero), an empty
map is replaced by a fixed patch, the per-instance features pass a dropout, and
the fusion and GT weights dilate with random widths (``compute_unknown_random``).
The train forward (``train_forward``) runs as the stages of selective remat
(``remat.py``), each through the runner the arch passes; ``forward`` in
train mode runs them as they are.

Sparse heads are densified with the -99 sentinel, so inactive sites decode to
alpha 0 after (tanh + 1) / 2 (reference ``:248-251,265-268``).

Off-by-default eval forms of the block ladder (``predict_details_block``):

- the lazy os1 shortcut: the encoder's ``shortcut.0`` runs on gathered
  patches of its input instead of the dense map, one K1 gather (the
  default with ``block`` mode; ``lazy_os2_shortcut``, the same one octave
  up, runs the dense branch: ``models/__init__.py``);
- ``phase_rung``: rung 3 takes its input through a dense hand-off, as the JAX
  package's phase-space rung 3 does (``maggie_tpu/models/decoder_sparse.py:355-360,
  407-476``): rung 2's cores are scattered into a dense os2 buffer and gathered
  again (K1), and ``fea1`` is gathered at os1 halo 4 (K1). The port runs the
  ordinary modules on those windows; the phase-major channel layout is a TPU
  lane layout and changes no number beyond summation order. Under capacity
  overflow the hand-off differs from the default's: a halo next to an active
  block that was dropped reads zeros from the buffer.

``atten_stride`` > 1 runs the os8 attention on average-pooled features
(``instance_decoder.py``).

Row-sharded (``parallel/space.py``; the train step only), os32 -> os8 and
the attention run replicated on the whole frame from the bands' pooled
masks; the os8 alpha is the band's rows of the whole frame's resize, K2 and
the random dilations take their reach's rows of the neighbours, the blocks
are selected on the gathered os8 map, and each rank runs those whose cores
lie in its band, gathering band-plus-halo maps and scattering into the
band.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn

from .. import parallel
from ..parallel import space
from . import remat
from .attention import FFNLayer
from .instance_decoder import InstanceMatteDecoder
from .layers import leaky_relu, res_layer_dec
from .sparse_layers import MaskedBatchNorm, SparseInverseConv, SubMConv, active_pyramid
from ..ops.blocksparse import gather_patches, gather_patches_rows, scatter_blocks, select_blocks
from ..ops.kernels.unknown import compute_unknown
from ..ops.morphology import compute_unknown_random
from ..ops.resize import resize_any_shape, resize_bilinear

SENTINEL = -99.0


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> the (N, H, W, C) view of the same memory, no copy: the gather
    kernel reads the encoder's NCHW planes as they are."""
    return x.permute(0, 2, 3, 1)


def _nchw(p: torch.Tensor) -> torch.Tensor:
    return p.permute(0, 3, 1, 2)


def _inside(idx_by, idx_bx, block: int, lo: int, size: int, limit) -> torch.Tensor:
    """(cap, 1, size, size) bool: the sites [b*block + lo, b*block + lo + size)
    of each entry's window that lie inside the (h, w) map ``limit``."""
    ar = torch.arange(lo, lo + size, device=idx_by.device)
    ys = idx_by[:, None] * block + ar
    xs = idx_bx[:, None] * block + ar
    return (((ys >= 0) & (ys < limit[0]))[:, :, None]
            & ((xs >= 0) & (xs < limit[1]))[:, None, :])[:, None]


def _per_instance(x: torch.Tensor, n_i: int) -> torch.Tensor:
    """(B, ...) -> (B*n_i, ...), each image repeated for its instances."""
    return x[:, None].expand((x.shape[0], n_i) + x.shape[1:]).reshape((-1,) + x.shape[1:])


@dataclass
class _Plan:
    """The blocks of the train ladder (``select_blocks``) and the masks its
    rungs share: the os1 and os2 masks (N, 1, H/s, W/s), and the os4 mask
    patches (``m4p6``) that rung 1 gathers and rung 2 reads.

    Row-sharded (``by0`` set), the entries are the blocks whose cores lie in
    this rank's band, which starts at block row ``by0``; ``idx_by`` stays the
    whole frame's. The dense maps are bands, gathered with their neighbours'
    halo rows (``gather_patches_rows``), except the whole os8 maps of a
    replicated stage (``whole``); cores scatter into the band."""
    idx_n: torch.Tensor
    idx_by: torch.Tensor
    idx_bx: torch.Tensor
    valid: torch.Tensor
    n_i: int
    m1: torch.Tensor
    m2: torch.Tensor
    m4p6: torch.Tensor | None = None
    by0: int | None = None

    def __post_init__(self):
        self.img_n = self.idx_n // self.n_i    # skip features are per image
        self.vmask = self.valid.float()[:, None, None, None]

    def gather(self, feat_nhwc, block: int, halo: int, per_image: bool = False,
               whole: bool = False):
        idx = self.img_n if per_image else self.idx_n
        if self.by0 is None or whole:
            return _nchw(gather_patches(feat_nhwc, idx, self.idx_by, self.idx_bx, block, halo))
        return _nchw(gather_patches_rows(feat_nhwc, idx, self.idx_by, self.idx_bx, block, halo,
                                         self.by0))

    def scatter(self, cores, shape, fill: float):
        by = self.idx_by if self.by0 is None else self.idx_by - self.by0
        return scatter_blocks(cores.permute(0, 2, 3, 1), self.idx_n, by, self.idx_bx,
                              self.valid, shape, fill=fill)

    def stats(self, mask_patch, lo: int, hi: int):
        """The BatchNorm statistics mask: the patch's core of valid blocks."""
        core = torch.zeros_like(mask_patch[:1])
        core[..., lo:hi, lo:hi] = 1.0
        return mask_patch * core * self.vmask


@dataclass
class TrainStep:
    """What the train stages read besides activations: the clip's sizes,
    the full-size guidance masks (b*n_f, n_i, H, W), the GT alphas and
    transitions, the step's flags and generator, the video decoder's memory,
    and ``finish`` (the arch's losses on the decoder's result)."""
    b: int
    n_f: int
    masks: torch.Tensor
    gt_alphas: torch.Tensor | None = None
    spar_gt: torch.Tensor | None = None
    use_mask_atten: bool = False
    use_gt_guidance: bool = False
    generator: torch.Generator | None = None
    mem_feat: torch.Tensor | None = None
    finish: Callable | None = None


class ResShortCutInstMattSpconvDec(nn.Module):
    def __init__(self, layers=(2, 3, 3, 2), atten_stride: float = 1.0, atten_dim: int = 128,
                 atten_block: int = 2, atten_head: int = 1, final_channel: int = 64,
                 max_inst: int = 10, use_id_pe: bool = True, large_kernel: bool = False,
                 sparse_mode: str = "oracle", block_cap_frac: float = 0.5,
                 phase_rung: bool = False, inst_spec_dropout: float = 0.1, **_unused):
        super().__init__()
        if sparse_mode not in ("block", "oracle"):
            raise ValueError(f"sparse_mode must be 'block' or 'oracle', not {sparse_mode!r}")
        self.sparse_mode = sparse_mode
        self.block_cap_frac = float(block_cap_frac)
        self.phase_rung = bool(phase_rung)
        k = 5 if large_kernel else 3
        fc = final_channel
        self.layer1 = res_layer_dec(512, 256, layers[0], 2)
        self.layer2 = res_layer_dec(256, 128, layers[1], 2)
        self.refine_OS8 = InstanceMatteDecoder(
            input_dim=128, attention_dim=atten_dim, n_block=atten_block, n_head=atten_head,
            output_dim=fc, max_inst=max_inst, use_id_pe=use_id_pe, atten_stride=atten_stride)
        self.inst_spec_layer = FFNLayer(fc, fc, dropout=inst_spec_dropout)
        act = nn.Identity  # activations are applied in forward; keeps reference indices
        # Sequential indices follow the reference definitions (:69-130)
        self.layer3 = nn.ModuleList([SparseInverseConv(fc, 64, 3, False), MaskedBatchNorm(64),
                                     act(), SubMConv(64, 64, 3, False)])
        self.guidance_layer = nn.ModuleList([SubMConv(128, 64, 1, False), MaskedBatchNorm(64),
                                             act(), SubMConv(64, 64, 3, True)])
        self.layer3_smooth = nn.ModuleList([SubMConv(64, 64, 1, True), act(),
                                            MaskedBatchNorm(64)])
        self.layer4 = nn.ModuleList([SparseInverseConv(64, 32, 3, False), MaskedBatchNorm(32),
                                     act(), SubMConv(32, 32, 1, False)])
        self.layer4_smooth = nn.ModuleList([SubMConv(64, 32, 1, True), act(),
                                            MaskedBatchNorm(32)])
        self.layer5 = nn.ModuleList([SparseInverseConv(32, 32, 3, False), MaskedBatchNorm(32),
                                     act(), SubMConv(32, 32, 3, False)])
        self.layer5_smooth = nn.ModuleList([SubMConv(64, 32, 1, True), act(),
                                            MaskedBatchNorm(32)])
        self.refine_OS4 = nn.ModuleList([SubMConv(64, 32, k, False), MaskedBatchNorm(32),
                                         act(), SubMConv(32, 1, k, True)])
        self.refine_OS1 = nn.ModuleList([SubMConv(32, 32, k, False), MaskedBatchNorm(32),
                                         act(), SubMConv(32, 1, k, True)])

    # ---- shared rung pieces (every mask is (N, 1, h, w), features NCHW) ----
    # (``stats``: the train-mode BatchNorm statistics mask; eval ignores it)
    def _inv_bn_subm(self, seq, x, m_coarse, m_fine, crop=None, stats=None):
        z = seq[0](x, m_coarse, m_fine)
        if crop is not None:
            z, m_fine = crop(z), crop(m_fine)
        return seq[3](leaky_relu(seq[1](z, m_fine, stats)), m_fine)

    def _guidance(self, detail, z, m4, stats=None):
        gate = self.guidance_layer[0](torch.cat([detail, z], dim=1), m4)
        gate = leaky_relu(self.guidance_layer[1](gate, m4, stats))
        gate = torch.sigmoid(self.guidance_layer[3](gate, m4))
        z = detail * gate * m4.to(detail.dtype)
        return self.layer3_smooth[2](torch.relu(self.layer3_smooth[0](z, m4)), m4, stats)

    @staticmethod
    def _smooth(seq, skip, z, m, stats=None):
        return seq[2](torch.relu(seq[0](torch.cat([skip, z], dim=1), m)), m, stats)

    @staticmethod
    def _head(seq, z, m, stats=None):
        h = seq[3](leaky_relu(seq[1](seq[0](z, m), m, stats)), m)
        m = m.to(h.dtype)
        return h * m + SENTINEL * (1.0 - m)

    def _inst_features(self, os8_feat, queries, m8, n_i, generator=None):
        """Query-gated per-instance os8 features, NHWC (N, h8, w8, C)."""
        dt = os8_feat.dtype
        x = _per_instance(os8_feat.permute(0, 2, 3, 1), n_i)
        g = queries.reshape(x.shape[0], 1, 1, queries.shape[-1]).to(dt)
        return (self.inst_spec_layer(x * g, generator)
                * m8.permute(0, 2, 3, 1).to(dt)).contiguous()

    def predict_details(self, os8_feat, roi_masks, queries, fea1, fea2, fea3, generator=None):
        """Dense-masked ladder. os8_feat (B, C, h8, w8); roi_masks (B, n_i, H, W);
        queries (B, n_i, C); fea1/fea2/fea3 (B, C, H/s, W/s) for s = 1, 2, 4.
        Returns logits (B, n_i, H/4, W/4) and (B, n_i, H, W) with the -99 sentinel."""
        B, n_i, H, W = roi_masks.shape
        dt = os8_feat.dtype
        m1 = roi_masks.reshape(B * n_i, 1, H, W).float()
        m1, m2, m4, m8 = (m.to(dt) for m in active_pyramid(m1))

        x = _nchw(self._inst_features(os8_feat, queries, m8, n_i, generator))
        x = self._inv_bn_subm(self.layer3, x, m8, m4)
        x = self._guidance(_per_instance(fea3, n_i) * m4, x, m4)
        x_os4 = self._head(self.refine_OS4, x, m4)
        x = self._inv_bn_subm(self.layer4, x, m4, m2)
        x = self._smooth(self.layer4_smooth, _per_instance(fea2, n_i) * m2, x, m2)
        x = self._inv_bn_subm(self.layer5, x, m2, m1)
        x = self._smooth(self.layer5_smooth, _per_instance(fea1, n_i) * m1, x, m1)
        x_os1 = self._head(self.refine_OS1, x, m1)
        return x_os4.reshape(B, n_i, H // 4, W // 4), x_os1.reshape(B, n_i, H, W)

    def predict_details_block(self, os8_feat, roi_masks, queries, fea1, fea2, fea3, sc0=None):
        """Fixed-capacity block-sparse form of ``predict_details`` (eval;
        ``maggie_tpu/models/decoder_sparse.py:189-405``). With capacity for every
        active block it equals the oracle; overflow drops the least-active blocks,
        whose alpha then falls back to the os8 prediction. ``sc0``: the lazy
        os1 shortcut's module and input, in place of ``fea1``."""
        B, n_i, H, W = roi_masks.shape
        N = B * n_i
        dt = os8_feat.dtype

        m1 = roi_masks.reshape(N, 1, H, W).float()
        _, _, _, m8 = active_pyramid(m1)

        B1 = 64  # os1 block
        nb = (H // B1) * (W // B1)
        cap = max(int(round(self.block_cap_frac * N * nb)), 1)  # round: half to even
        idx_n, idx_by, idx_bx, valid = select_blocks(m8[:, 0], B1 // 8, cap)
        img_n = idx_n // n_i  # skip features are per image

        def gather(feat_nhwc, idx, block, halo):
            return _nchw(gather_patches(feat_nhwc, idx, idx_by, idx_bx, block, halo))

        def in_bounds(win, lo, blk, limit):
            # zero sites whose absolute index falls outside the dense map
            return win * _inside(idx_by, idx_bx, blk, lo, win.shape[-1], limit).to(win.dtype)

        # The mask pyramid of every window from ONE gather of the os1 mask (halo
        # 32) and in-patch max-pools: k3 s2, no padding, -inf init (:232-255).
        p1 = gather(m1.reshape(N, H, W, 1), idx_n, 64, 32)                  # (cap,1,128,128)
        pool = lambda x: torch.nn.functional.max_pool2d(x, 3, 2)
        p2 = pool(p1[..., 1:, 1:])                                            # os2 [-15,47]
        p4 = pool(p2)                                                         # os4 [-7,23]
        p8 = pool(p4)                                                         # os8 [-3,11]
        m1p4 = p1[..., 28:100, 28:100]                                        # os1 [-4,68)
        m2p2 = in_bounds(p2[..., 13:49, 13:49], -2, 32, (H // 2, W // 2))
        m4p6 = in_bounds(p4[..., 1:29, 1:29], -6, 16, (H // 4, W // 4))
        m8p = in_bounds(p8[..., 0:14, 0:14], -3, 8, (H // 8, W // 8))

        x8 = self._inst_features(os8_feat, queries, m8, n_i)                 # NHWC

        # ---- rung 1: os8 -> os4 (core 16, os4 halo 4) ----
        x8p = gather(x8, idx_n, 8, 3)                                         # (cap,C,14,14)
        crop4 = lambda t: t[..., 2:26, 2:26]
        z = self._inv_bn_subm(self.layer3, x8p, m8p, m4p6, crop4)            # (cap,64,24,24)
        m4p = crop4(m4p6)
        f3p = gather(_nhwc(fea3), img_n, 16, 4) * m4p.to(dt)
        z = self._guidance(f3p, z, m4p)
        h4 = self._head(self.refine_OS4, z, m4p)
        x_os4 = scatter_blocks(h4[..., 4:20, 4:20].permute(0, 2, 3, 1), idx_n, idx_by, idx_bx,
                               valid, (N, H // 4, W // 4, 1), fill=SENTINEL)

        # ---- rung 2: os4 -> os2 (core 32) ----
        # The rung hand-off is fused (:310-331): the next rung slices its input
        # window straight out of this rung's patch stack instead of scattering
        # to a dense buffer and gathering again; the extra halo sites are
        # recomputed locally and equal the oracle's.
        x4p = z[..., 3:22, 3:22]                                              # os4 [-1,17]
        m4p1 = m4p6[..., 5:24, 5:24]
        m2w = in_bounds(p2[..., 13:51, 13:51], -2, 32, (H // 2, W // 2))      # 38 wide
        z = self.layer4[0](x4p, m4p1, m2w)[..., 0:36, 0:36]                   # os2 [-2,34)
        z = self.layer4[3](leaky_relu(self.layer4[1](z, m2p2)), m2p2)
        f2p = gather(_nhwc(fea2), img_n, 32, 2) * m2p2.to(dt)
        z = self._smooth(self.layer4_smooth, f2p, z, m2p2)

        # ---- rung 3: os2 -> os1 (core 64) ----
        if self.phase_rung:
            # the dense hand-off of the JAX package's phase-space rung 3
            # (:355-360, :407-476): rung 2's cores through a dense os2 buffer,
            # and every window at os1 halo 4, [-4, 68)
            x2 = scatter_blocks(z[..., 2:34, 2:34].permute(0, 2, 3, 1), idx_n, idx_by, idx_bx,
                                valid, (N, H // 2, W // 2, z.shape[1]), fill=0.0)
            z = self._inv_bn_subm(self.layer5, gather(x2, idx_n, 32, 2), m2p2, m1p4)
            m1p, lo = m1p4, 4                                                 # (cap,32,72,72)
            f1p = gather(_nhwc(fea1), img_n, 64, 4) * m1p.to(dt)
        else:
            # os1 halo 3, the input sliced from rung 2's patch stack
            crop1 = lambda t: t[..., 1:71, 1:71]
            z = self._inv_bn_subm(self.layer5, z, m2p2, m1p4, crop1)         # (cap,32,70,70)
            m1p, lo = crop1(m1p4), 3
            if sc0 is not None:
                # lazy os1 skip features (:377-391): gather the 6-channel
                # encoder input with halo 5 and run shortcut.0 on the patches;
                # [2:72] is the exactly-valid interior after two 3x3 convs.
                # inner_mask zeroes the intermediate beyond the image border,
                # where the dense branch's second conv saw zero padding.
                sc0_fn, sc0_inp = sc0
                p6 = gather(_nhwc(sc0_inp), img_n, 64, 5)                     # (cap,6,74,74)
                inner = _inside(idx_by, idx_bx, 64, -5, 74, (H, W))
                f1p = sc0_fn(p6, inner)[..., 2:72, 2:72] * m1p.to(dt)
            else:
                f1p = gather(_nhwc(fea1), img_n, 64, 3) * m1p.to(dt)
        z = self._smooth(self.layer5_smooth, f1p, z, m1p)
        h1 = self._head(self.refine_OS1, z, m1p)
        x_os1 = scatter_blocks(h1[..., lo:lo + 64, lo:lo + 64].permute(0, 2, 3, 1), idx_n,
                               idx_by, idx_bx, valid, (N, H, W, 1), fill=SENTINEL)
        return (x_os4[..., 0].reshape(B, n_i, H // 4, W // 4),
                x_os1[..., 0].reshape(B, n_i, H, W))

    def predict_details_block_train(self, os8_feat, roi_masks, queries, fea1, fea2, fea3,
                                    generator=None):
        """Train form of the block ladder (``maggie_tpu/models/decoder_sparse.py:209-402``,
        ``train=True``): per-scale gathers of the masks and features (the
        gathers of x8, fea3, the os4 and os2 hand-off buffers and fea2, fea1
        are differentiable), dense scatter -> gather hand-offs between rungs,
        and BatchNorm statistics over the halo-free cores of valid blocks, so
        that each active site counts once (the dense oracle's masked
        statistics, when no block overflows the capacity). The rungs are
        the stages of selective remat (``remat.py``); the dense hand-offs
        ``x4`` and ``x2`` are the JAX package's tags ``x4_dense`` and
        ``x2_dense`` (``:313``, ``:365``)."""
        x_os4, x4, plan = self._rung1_train(os8_feat, roi_masks, queries, fea3, generator)
        x2, m2p2 = self._rung2_train(x4, fea2, plan)
        return x_os4, self._rung3_train(x2, fea1, plan, m2p2)

    def _rung1_train(self, os8_feat, roi_masks, queries, fea3, generator):
        """Block choice and rung 1, os8 -> os4 (core 16, os4 halo 4). Returns
        the os4 logits (B, n_i, H/4, W/4), the dense os4 hand-off ``x4``
        (N, H/4, W/4, 64) and the ``_Plan`` of the later rungs."""
        B, n_i, hb, W = roi_masks.shape
        N = B * n_i
        dt = os8_feat.dtype
        m1 = roi_masks.reshape(N, 1, hb, W).float()
        _, m2, m4, m8 = active_pyramid(m1)
        if space.banded():
            # blocks of the shard's whole frame, from the gathered os8 map
            m8 = space.gather_rows(m8)
        H = m8.shape[-2] * 8
        cap = max(int(round(self.block_cap_frac * N * (H // 64) * (W // 64))), 1)
        blocks = select_blocks(m8[:, 0], 8, cap)
        remat.replayed("blocks", *blocks)
        if space.banded():
            # this rank runs the blocks whose cores lie in its band
            by0 = space.band(H // 64)[0]
            keep = (blocks[1] >= by0) & (blocks[1] < by0 + hb // 64)
            p = _Plan(*(t[keep] for t in blocks), n_i, m1, m2, by0=by0)
        else:
            p = _Plan(*blocks, n_i, m1, m2)

        x8 = self._inst_features(os8_feat, queries, m8, n_i, generator)      # NHWC
        x8p = p.gather(x8, 8, 3, whole=True)                                  # (cap,C,14,14)
        m8p = p.gather(_nhwc(m8), 8, 3, whole=True)
        m4p6 = p.m4p6 = p.gather(_nhwc(m4), 16, 6)                            # (cap,1,28,28)
        crop4 = lambda t: t[..., 2:26, 2:26]
        m4p = crop4(m4p6)
        s4 = p.stats(m4p, 4, 20)
        z = self._inv_bn_subm(self.layer3, x8p, m8p, m4p6, crop4, s4)       # (cap,64,24,24)
        f3p = p.gather(_nhwc(fea3), 16, 4, per_image=True) * m4p.to(dt)
        z = self._guidance(f3p, z, m4p, s4)
        h4 = self._head(self.refine_OS4, z, m4p, s4)
        x_os4 = p.scatter(h4[..., 4:20, 4:20], (N, hb // 4, W // 4, 1), SENTINEL)
        x4 = p.scatter(z[..., 4:20, 4:20], (N, hb // 4, W // 4, z.shape[1]), 0.0)
        return x_os4[..., 0].reshape(B, n_i, hb // 4, W // 4), x4, p

    def _rung2_train(self, x4, fea2, p):
        """Rung 2, os4 -> os2 (core 32), from the dense os4 hand-off; returns
        the dense os2 hand-off ``x2`` (N, H/2, W/2, 32) and the os2 mask
        patches that rung 3 reads."""
        dt = x4.dtype
        N, h4, w4, _ = x4.shape
        x4p = p.gather(x4, 16, 1)                                             # (cap,64,18,18)
        m2p2 = p.gather(_nhwc(p.m2), 32, 2)                                   # (cap,1,36,36)
        z = self.layer4[0](x4p, p.m4p6[..., 5:23, 5:23], m2p2)                # (cap,32,36,36)
        z = leaky_relu(self.layer4[1](z, m2p2, p.stats(m2p2, 2, 34)))
        m2p = m2p2[..., 2:34, 2:34]
        z = self.layer4[3](z[..., 2:34, 2:34], m2p)
        f2p = p.gather(_nhwc(fea2), 32, 0, per_image=True) * m2p.to(dt)
        z = self._smooth(self.layer4_smooth, f2p, z, m2p, m2p * p.vmask)
        return p.scatter(z, (N, 2 * h4, 2 * w4, z.shape[1]), 0.0), m2p2

    def _rung3_train(self, x2, fea1, p, m2p2):
        """Rung 3, os2 -> os1 (core 64, os1 halo 3), from the dense os2
        hand-off; returns the os1 logits (B, n_i, H, W)."""
        dt = x2.dtype
        N, _, H, W = p.m1.shape
        x2p = p.gather(x2, 32, 2)                                             # (cap,32,36,36)
        m1p4 = p.gather(_nhwc(p.m1), 64, 4)                                   # (cap,1,72,72)
        crop1 = lambda t: t[..., 1:71, 1:71]
        m1p = crop1(m1p4)
        s1 = p.stats(m1p, 3, 67)
        z = self._inv_bn_subm(self.layer5, x2p, m2p2, m1p4, crop1, s1)       # (cap,32,70,70)
        f1p = p.gather(_nhwc(fea1), 64, 3, per_image=True) * m1p.to(dt)
        z = self._smooth(self.layer5_smooth, f1p, z, m1p, s1)
        h1 = self._head(self.refine_OS1, z, m1p, s1)
        x_os1 = p.scatter(h1[..., 3:67, 3:67], (N, H, W, 1), SENTINEL)
        return x_os1[..., 0].reshape(N // p.n_i, p.n_i, H, W)

    def fuse(self, alpha_os1, alpha_os4, alpha_os8, detail_mask, generator=None):
        """PRM fusion restricted to the detail mask (reference ``fuse``, :272-290);
        in train mode the dilation widths are random (``compute_unknown_random``)."""
        unknown = ((lambda a, k: compute_unknown_random(a, k, generator)) if self.training
                   else compute_unknown)
        alpha = alpha_os8
        w4 = (unknown(alpha, 27) * detail_mask > 0).to(alpha.dtype)
        alpha = alpha_os4 * w4 + alpha * (1 - w4)
        w1 = (unknown(alpha, 15) * detail_mask > 0).to(alpha.dtype)
        alpha = alpha_os1 * w1 + alpha * (1 - w1)
        return alpha, w4, w1

    def forward(self, x, mid_fea: dict, b: int, n_f: int, n_i: int, masks,
                gt_alphas=None, use_mask_atten: bool = False, use_gt_guidance: bool = False,
                generator: torch.Generator | None = None, spar_gt=None, **_unused) -> dict:
        """x (b*n_f, 512, h32, w32); masks (b*n_f, n_i_in, H, W) guidance masks.

        Train mode also takes ``gt_alphas`` (b*n_f, n_i, H, W), the step's
        flags and the ``generator`` of its random draws (dropout, dilation
        widths), and adds the fusion weights and the attention loss to the
        result (``train_forward``)."""
        if self.training:
            step = TrainStep(b, n_f, masks, gt_alphas, spar_gt, use_mask_atten, use_gt_guidance,
                             generator)
            return self.train_forward(remat.Stages(), x, mid_fea["shortcut"], step)
        return self._decode(x, mid_fea, b, n_f, n_i, masks)[0]

    def _attend(self, z, masks5, gt_masks, use_mask_atten: bool, mem_feat=None):
        """The os8 instance attention (the video decoder adds its memory)."""
        return self.refine_OS8(z, masks5, gt_masks, use_mask_atten)

    def _lazy_shortcut(self, mid_fea: dict):
        """The lazy os1 shortcut's (module, input), None where the encoder
        gave the dense ``fea1``; the JAX package's error for the forms that
        cannot take it (``:509-511``)."""
        if mid_fea["shortcut"][0] is not None:
            return None
        if self.sparse_mode != "block" or self.phase_rung:
            raise ValueError("lazy os1 shortcut requires sparse_mode='block' without phase_rung")
        return mid_fea["shortcut0_fn"], mid_fea["shortcut0_input"]

    def _decode(self, x, mid_fea, b, n_f, n_i, masks, mem_feat=None):
        """The eval forward's result, and the os8 features and the attention's
        hidden state."""
        fea1, fea2, fea3, fea4, fea5 = mid_fea["shortcut"]
        h, w = mid_fea["image"].shape[2:]
        sc0 = self._lazy_shortcut(mid_fea)
        masks5 = masks.reshape((b, n_f) + masks.shape[1:])
        z = self.layer1(x) + fea5
        z = self.layer2(z) + fea4
        x_os8_logit, feat8, queries, _, hidden = self._attend(z, masks5, None, False, mem_feat)
        # slice the instance slots before the full-resolution upsample
        # (exact: resize and tanh act per channel)
        x_os8 = resize_bilinear(x_os8_logit[:, :n_i], (h, w), align_corners=False)
        x_os8 = (torch.tanh(x_os8) + 1.0) / 2.0
        unknown_os8 = compute_unknown(x_os8, k_size=30)
        q = queries[:, None].expand((b, n_f) + queries.shape[1:])
        q = q.reshape((b * n_f,) + queries.shape[1:])[:, :n_i]
        if self.sparse_mode == "block":
            x_os4_log, x_os1_log = self.predict_details_block(
                feat8, unknown_os8, q, fea1, fea2, fea3, sc0=sc0)
        else:
            x_os4_log, x_os1_log = self.predict_details(feat8, unknown_os8, q, fea1, fea2, fea3)
        x_os4, x_os1 = self._os4_os1_alphas(x_os4_log, x_os1_log, h, w)
        alpha, _, _ = self.fuse(x_os1, x_os4, x_os8, unknown_os8)
        ret = {"alpha_os1": x_os1, "alpha_os4": x_os4, "alpha_os8": x_os8,
               "refined_masks": alpha, "detail_mask": unknown_os8}
        return ret, feat8, hidden

    @staticmethod
    def _os4_os1_alphas(x_os4_log, x_os1_log, h: int, w: int):
        """The os4 and os1 logits as alphas at (h, w), f32 whatever the
        ladder's compute dtype (:580-583); on a band, the band's rows of the
        whole frame's resize, from the os4 band and a row of either
        neighbour."""
        x_os4 = space.resize_rows(x_os4_log.float(), (h, w), halo=1)
        x_os4 = (torch.tanh(x_os4) + 1.0) / 2.0
        x_os1 = (torch.tanh(x_os1_log.float()) + 1.0) / 2.0
        return x_os4, x_os1

    # ---- train: the forward in the stages of selective remat (remat.py) ----
    # The JAX image decoder tags the os8 attention's outputs as a stage
    # (``maggie_tpu/models/decoder_sparse.py:537-538``); the video decoder
    # does not (``tag_os8 = False`` there).
    tag_os8 = True

    def train_forward(self, run, x, feas, step: TrainStep):
        """The train forward from the ASPP output ``x`` and the encoder's
        ``feas`` (fea1 to fea5), as stages 3 to 6 of ``remat.py``, each
        through ``run`` (``remat.Stages``). ``step.finish(pred)`` (the arch's
        losses) runs in the last stage and its result is returned; without
        it, ``pred``."""
        fea1, fea2, fea3, fea4, fea5 = feas
        if self.sparse_mode != "block":
            # the dense ladder has no stage tags: stages 4 to 6 are one
            return self._after_os8(run, self._train_dense, x, fea5, fea4, fea1, fea2, fea3, step)
        (x_os8, unknown_os8, use_gt, x_os4_log, feat8, atten_loss, x4,
         plan) = self._after_os8(run, self._train_rung1, x, fea5, fea4, fea3, step)
        x2, m2p2 = run(self._rung2_train, x4, fea2, plan)
        return run(self._train_rung3_tail, x2, m2p2, fea1, plan, x_os8, unknown_os8, use_gt,
                   x_os4_log, feat8, atten_loss, step)

    def _after_os8(self, run, fn, x, fea5, fea4, *args):
        """``fn(*os8 stage's outputs, *args)``: a stage of its own after the
        os8 stage where the os8 outputs are tagged, else in the os8 stage."""
        if self.tag_os8:
            return run(fn, *run(self._train_os8, x, fea5, fea4, args[-1]), *args)
        return run(self._os8_then, fn, x, fea5, fea4, *args)

    def _os8_then(self, fn, x, fea5, fea4, *args):
        return fn(*self._train_os8(x, fea5, fea4, args[-1]), *args)

    def _train_os8(self, x, fea5, fea4, step: TrainStep):
        """Stage 3: os32 -> os8 and the instance attention, supervised by the
        GT masks. Returns (x_os8_logit, feat8, queries, attention loss).
        A replicated stage under row sharding: the attention takes the whole
        frame's masks pooled to os8 (as it pools them itself) from the
        bands."""
        five = lambda t: t.reshape((step.b, step.n_f) + t.shape[1:])
        gt_masks = None
        if space.banded():
            masks5 = five(space.frame_mask_pool(step.masks, 8, use_max=False))
            if step.gt_alphas is not None:
                gt_masks = five(space.frame_mask_pool((step.gt_alphas > 0).float(), 8, True))
        else:
            masks5 = five(step.masks)
            if step.gt_alphas is not None:
                gt_masks = five((step.gt_alphas > 0).float())
                if gt_masks.shape[-1] != masks5.shape[-1]:
                    gt_masks = resize_any_shape(gt_masks, use_max_pool=True,
                                                scale_factor=masks5.shape[-1] / gt_masks.shape[-1])
        with parallel.replicated():
            z = self.layer1(x) + fea5
            z = self.layer2(z) + fea4
            x_os8_logit, feat8, queries, loss_max_atten, _ = self._attend(
                z, masks5, gt_masks, step.use_mask_atten, step.mem_feat)
        return x_os8_logit, feat8, queries, loss_max_atten

    def _train_os8_alpha(self, x_os8_logit, queries, step: TrainStep):
        """The os8 alpha gated by the valid masks, the GT guidance flag and
        the uncertainty map (K2) that drives the ladder, and the queries per
        frame."""
        b, n_f = step.b, step.n_f
        hb, w = step.masks.shape[-2:]
        x_os8 = space.resize_rows(x_os8_logit, (hb, w))   # on a band: the band's rows
        x_os8 = (torch.tanh(x_os8) + 1.0) / 2.0
        x_os8 = x_os8 * (space.frame_sum(step.masks) > 0).float()
        guided, use_gt = x_os8, None
        if step.gt_alphas is not None:
            # warmup guidance by the GT, and its rescue of an all-zero
            # prediction (:552-558), as a select on the card; both tests
            # here are the global batch's under data parallelism
            use_gt = (parallel.global_sum(x_os8.sum()) == 0) | step.use_gt_guidance
            guided = torch.where(use_gt, step.gt_alphas, x_os8)
        # K2 (on a band: with its neighbours' rows)
        unknown_os8 = space.rows_op(guided, 15, lambda t: compute_unknown(t, k_size=30))
        # an empty uncertainty map gets a fixed patch (:563-568), rows
        # 200:250 of the whole frame
        lo = space.band(hb * space.world())[0]
        patch = torch.zeros_like(unknown_os8)
        patch[:, :, max(200 - lo, 0):max(250 - lo, 0), 200:250] = 1.0
        unknown_os8 = torch.where(parallel.global_max(unknown_os8.amax()) == 0, patch, unknown_os8)
        q = queries[:, None].expand((b, n_f) + queries.shape[1:])
        q = q.reshape((b * n_f,) + queries.shape[1:])[:, :x_os8.shape[1]]
        return x_os8, use_gt, unknown_os8, q

    def _train_rung1(self, x_os8_logit, feat8, queries, atten_loss, fea3, step: TrainStep):
        """Stage 4: the os8 alpha, the uncertainty map and rung 1, out to the
        dense os4 hand-off (the JAX tag ``x4_dense``)."""
        x_os8, use_gt, unknown_os8, q = self._train_os8_alpha(x_os8_logit, queries, step)
        x_os4_log, x4, plan = self._rung1_train(feat8, unknown_os8, q, fea3, step.generator)
        return x_os8, unknown_os8, use_gt, x_os4_log, feat8, atten_loss, x4, plan

    def _train_rung3_tail(self, x2, m2p2, fea1, plan, x_os8, unknown_os8, use_gt, x_os4_log,
                          feat8, atten_loss, step: TrainStep):
        """Stage 6: rung 3, then ``_train_tail``."""
        x_os1_log = self._rung3_train(x2, fea1, plan, m2p2)
        return self._train_tail(x_os1_log, x_os4_log, x_os8, unknown_os8, use_gt, feat8,
                                atten_loss, step)

    def _train_dense(self, x_os8_logit, feat8, queries, atten_loss, fea1, fea2, fea3,
                     step: TrainStep):
        """Stages 4 to 6 with the dense oracle ladder (``predict_details``)."""
        x_os8, use_gt, unknown_os8, q = self._train_os8_alpha(x_os8_logit, queries, step)
        x_os4_log, x_os1_log = self.predict_details(feat8, unknown_os8, q, fea1, fea2, fea3,
                                                    step.generator)
        return self._train_tail(x_os1_log, x_os4_log, x_os8, unknown_os8, use_gt, feat8,
                                atten_loss, step)

    def _train_tail(self, x_os1_log, x_os4_log, x_os8, unknown_os8, use_gt, feat8, atten_loss,
                    step: TrainStep):
        """The alphas, the fusion with random-width dilations, the GT's
        weights while the GT guides, the temporal part (``_train_temporal``)
        and ``step.finish``."""
        h, w = step.masks.shape[-2:]
        x_os4, x_os1 = self._os4_os1_alphas(x_os4_log, x_os1_log, h, w)
        alpha, w4, w1 = self.fuse(x_os1, x_os4, x_os8, unknown_os8, step.generator)
        if use_gt is not None:
            # the GT's own weights while the GT guides (:591-595)
            w4_gt = compute_unknown_random(step.gt_alphas, 30, step.generator) * unknown_os8
            w1_gt = compute_unknown_random(step.gt_alphas, 15, step.generator) * unknown_os8
            w4, w1 = torch.where(use_gt, w4_gt, w4), torch.where(use_gt, w1_gt, w1)
        ret = {"alpha_os1": x_os1, "alpha_os4": x_os4, "alpha_os8": x_os8,
               "refined_masks": alpha, "detail_mask": unknown_os8, "weight_os4": w4,
               "weight_os1": w1, "loss_max_atten": atten_loss}
        self._train_temporal(ret, feat8, step)
        return ret if step.finish is None else step.finish(ret)

    def _train_temporal(self, ret: dict, feat8, step: TrainStep) -> None:
        """Hook for the video decoder's bidirectional fusion and temporal losses."""

