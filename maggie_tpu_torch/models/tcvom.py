"""TCVOM, the MGM baseline with temporal feature aggregation (port of
``maggie_tpu/models/tcvom.py``; reference ``maggie/network/arch/tcvom.py``).

A clip's frames all go through the encoder, ASPP and a first decoder pass
(``decoder_fam.py``) without the FAM. The unknown band of each frame is the
max over its instances of a 15x15 max pool of ``0.01 < alpha_os1 < 0.99``;
each middle frame then takes a second decoder pass whose FAM attends to the
previous and the next frame's os8 features on that band. The first and last
frames keep the first pass. The harness's ``fuse`` follows (K2 at k=30 and
k=15 in eval), then in train the losses with ``loss_reweight_os8`` off
(``:118-122``) and the window-9 attention BCE (``compute_atten_loss``), added
whenever ``loss_atten_w > 0``: TCVOM reads none of the step's flags.

As in the JAX package, TCVOM never casts its input to the precision's
compute dtype (``:41``), so it runs in f32 under ``--precision 16`` too, and
it does not gate its predictions by the valid instances in train.
``TCVOM_SingInst`` runs one instance at a time in eval. Neither splits its
eval forward (``split_eval``): streaming video eval runs the whole forward
on every window.

Under ``model.remat selective`` (``remat.py``) the train forward has two
segments, as the JAX package tags only the encoder's outputs
(``maggie_tpu/models/encoder.py:171-185``; ``tcvom.py:65`` leaves ASPP's
untagged): the encoder over every frame, then ASPP, the first decoder pass,
the FAM passes (whose spectral norms chain their power steps within the
segment), the fusion and the losses. Under data parallelism the attention
loss divides by the global batch's band count (``compute_atten_loss``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import remat
from .. import parallel
from .layers import end_sn_chains, per_frame
from .maggie import MaGGIe
from .mgm_wrappers import one_instance_at_a_time
from ..ops.resize import avg_pool2d

def _maxpool_same_map(x: torch.Tensor, k: int = 15) -> torch.Tensor:
    """Max over the k x k window of each pixel of maps (..., H, W)."""
    lead, hw = x.shape[:-2], x.shape[-2:]
    y = F.max_pool2d(x.reshape((-1, 1) + hw), k, 1, k // 2)
    return y.reshape(lead + hw)


class TCVOM(MaGGIe):
    split_eval = False

    def forward(self, batch: dict, generator: torch.Generator | None = None, **_flags):
        """Eval: the true instances' outputs (b, n_f, n_i, H, W). Train:
        ``(output, loss_dict)``, every draw from ``generator``; the step's
        flags, and eval's ``mem_feat``/``prev_pred``, are accepted and
        ignored."""
        if not self.training:
            with torch.no_grad():
                return self._forward(batch, False, None)
        try:
            return self._forward(batch, True, generator)
        finally:
            end_sn_chains(self)

    def _forward(self, batch: dict, train: bool, generator):
        inp, _, gt, dims = self._inputs(batch, train, batch["image"].dtype)
        if not train:
            return self._clip(*self._encoded(inp), dims)
        run = remat.Stages(self.remat == "selective", generator)
        out, *feas = run(self._train_encode, inp)                            # stage 1
        return run(self._train_clip, out, feas, gt, dims, generator)         # stage 2

    def _encoded(self, inp: torch.Tensor):
        """Eval: the ASPP output and the five skip features of every frame, a
        frame at a time, as ``MaGGIe.encode_frames`` encodes: with TF32 off,
        cuDNN picks FFT convolutions for a batch of 3 frames
        (``layers.per_frame``; ``PERF.md`` gives TCVOM's window both ways)."""
        def encode(x):
            out, mid_fea = self.encoder(x)
            return (self.aspp(out),) + tuple(mid_fea["shortcut"])
        embedding, *shortcuts = per_frame(encode, inp)
        return embedding, tuple(shortcuts)

    def _train_clip(self, out, feas, gt: dict, dims, generator):
        """Stage 2 of the train forward: ASPP, the decoder passes, the fusion
        and the losses."""
        return self._clip(self.aspp(out), tuple(feas), dims, gt, generator)

    def _clip(self, embedding, shortcuts, dims, gt: dict | None = None, generator=None):
        """The decoder passes over the clips of ``embedding`` and the skip
        features, and the fusion: the output, and in train ``(output,
        loss_dict)``."""
        b, n_f, n_i, h, w = dims
        # the first pass over every frame, without the FAM (:26)
        raw, features, _, _, _ = self.decoder(embedding, shortcuts)
        unknown = self.dilate(raw["alpha_os1"])
        unknown = unknown.reshape((b, n_f, -1, h, w)).amax(dim=2, keepdim=True)
        clips = lambda t: t.reshape((b, n_f) + t.shape[1:])
        feats, emb, sc = clips(features), clips(embedding), [clips(f) for f in shortcuts]
        preds = {k: [clips(v)[:, 0]] for k, v in raw.items()}
        attb, attf, small_mask = [None] * n_f, [None] * n_f, [None] * n_f
        for i in range(1, n_f - 1):
            pred, _, attb[i], attf[i], small_mask[i] = self.decoder(
                emb[:, i], [f[:, i] for f in sc], xb=feats[:, i - 1], xf=feats[:, i + 1],
                mask=unknown[:, i])
            for k, v in pred.items():
                preds[k].append(v)
        for k, v in raw.items():
            preds[k].append(clips(v)[:, -1])
            preds[k] = torch.stack(preds[k], dim=1).reshape((-1, self.num_masks, h, w))

        alpha, weight_os4, weight_os1 = self.fuse(preds, generator)
        output = self._transform_output({**preds, "refined_masks": alpha}, b, n_f, n_i, h, w)
        if gt is None:
            return output
        loss_dict = self.compute_loss(preds, weight_os4, weight_os1, gt["alpha"],
                                      (b, n_f, n_i, h, w), reweight_os8=False)
        if self.loss_atten_w > 0:
            amax = gt["alpha"].reshape((b, n_f, -1, h, w)).amax(dim=2, keepdim=True)
            loss_atten = self.compute_atten_loss(amax, attb, attf, small_mask)
            loss_dict["loss_atten"] = loss_atten
            loss_dict["total"] = loss_dict["total"] + loss_atten * self.loss_atten_w
        return output, loss_dict

    @staticmethod
    def dilate(alpha: torch.Tensor) -> torch.Tensor:
        """The unknown band: a 15x15 max pool of ``0.01 < alpha < 0.99``."""
        return _maxpool_same_map(((alpha > 0.01) & (alpha < 0.99)).float(), 15)

    @staticmethod
    def compute_atten_loss(alphas, attb, attf, small_mask) -> torch.Tensor:
        """Window-9 attention BCE (reference ``:93-129``): for each middle
        frame, the FAM's logits against whether each window position's os8
        GT alpha lies within 0.3 of the query's (label 0.8, else 0), on the
        band only; 0 for a frame whose band is empty in the global batch.
        ``alphas`` (b, n_f, 1, H, W) the GT's max over instances."""
        os = 8
        bs, n_f, _, hh, ww = alphas.shape
        hw = (hh // os) * (ww // os)
        losses = []
        for c in range(1, n_f - 1):
            # (bs, 81, h*w): each position's 9x9 window of the pooled GT
            bgt, fgt = (F.unfold(avg_pool2d(alphas[:, t], os), 9, padding=4) for t in (c - 1, c + 1))
            cgt = avg_pool2d(alphas[:, c], os).reshape(bs, 1, hw)
            m = small_mask[c].reshape(bs, hw)
            # the global batch's band count (the JAX package's, one jit over
            # it): the ranks' numerators then add up to the global loss
            cnt = parallel.global_sum(m.sum())

            def masked_bce(logits, labels):
                per = (torch.clamp(logits, min=0) - logits * labels
                       + torch.log1p(torch.exp(-logits.abs()))) * m[:, None, :]
                return per.sum() / torch.clamp(cnt * per.shape[1], min=1.0)

            dcb = ((cgt - bgt).abs() < 0.3).float() * 0.8
            dcf = ((cgt - fgt).abs() < 0.3).float() * 0.8
            loss = (masked_bce(attb[c], dcb) + masked_bce(attf[c], dcf)) / 2.0
            losses.append(torch.where(cnt > 0, loss, torch.zeros_like(loss)))
        return sum(losses) / float(len(losses))


class TCVOMSingInst(TCVOM):
    def forward(self, batch: dict, generator: torch.Generator | None = None, **flags):
        if self.training:
            return super().forward(batch, generator, **flags)
        return one_instance_at_a_time(super().forward, batch)
