"""MaGGIe architecture: encoder -> ASPP -> decoder with PRM fusion, and the
training loss (port of ``maggie_tpu/models/maggie.py``; reference
``network/arch/maggie.py``). Arch ``MGM`` is this harness with the dense
decoder (``decoder_dense.py``), whose alphas it fuses itself (``fuse``).

Interface as in the JAX package: ``batch['image']`` (b, n_f, H, W, 3) float,
``batch['mask']`` (b, n_f, n_i, hm, wm); in training also ``batch['alpha']``
and ``batch['transition']`` (b, n_f, n_i, H, W).

In eval (``model.eval()``, as ``build_model`` returns it) the forward runs
without autograd and returns the true instances' outputs (b, n_f, n_i, H, W),
as ``encode_frames`` then ``decode_window`` (the halves that streaming video
eval calls apart); ``mem_feat`` and ``prev_pred`` reach the video arch.
In train mode (``model.train()``) it pads masks, alphas and transitions to
``num_masks`` slots, gates the predictions by the valid instances and returns
``(output, loss_dict)``: the weighted L1 + Laplacian + Sobel-gradient (+ dtSSD)
losses at os1 (x2), os4 and os8 (``compute_loss``, ``:300-373``) and the
attention loss. The step's flags are the JAX package's static ones
(``:83-94``); ``generator`` feeds every random draw of the forward. Under
``model.remat selective`` (``remat.py``; the train step sets ``self.remat``)
the train forward runs its stages in checkpoint segments. Row-sharded
(``parallel/space.py``; ``check_rows`` says what may be), the frames are
bands: the encoder and decoder exchange rows, ASPP runs replicated, and the
losses' frame-wide flags and the attention loss count the whole frame once.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn

from . import remat
from .. import parallel
from ..parallel import space
from .aspp import ASPP
from .decoder_sparse import TrainStep
from .layers import end_sn_chains
from .losses import gradient_loss, lap_loss, loss_dtssd, regression_loss
from ..ops.kernels.unknown import compute_unknown
from ..ops.morphology import compute_unknown_random
from ..ops.resize import resize_nearest

_SPARSE_DECODERS = ("res_shortcut_inst_matt_spconv_22", "res_shortcut_inst_matt_spconv_temp_22")
_LAZY_OS1_ENCODERS = ("res_shortcut_embed_29",)
_ALPHAS = ("alpha_os1", "alpha_os4", "alpha_os8")


def prm_fuse(alpha_os8, alpha_os4, alpha_os1, training: bool,
             generator: torch.Generator | None = None):
    """PRM fusion (reference ``fuse``, ``:51-61``): the os4 alpha where the
    os8 alpha's uncertain band (k=30) reaches, then the os1 alpha where the
    result's band (k=15) does. In eval K2 (``compute_unknown``) computes the
    bands, in train the random-width dilation draws from ``generator``, k=30
    first. Returns the fused alpha and the two 0/1 bands (the os4 and os1
    loss weights)."""
    if training:
        unknown = lambda a, k: compute_unknown_random(a, k, generator)
    else:
        unknown = compute_unknown
    w4 = unknown(alpha_os8, 30)
    alpha = torch.where(w4 > 0, alpha_os4, alpha_os8)
    w1 = unknown(alpha, 15)
    return torch.where(w1 > 0, alpha_os1, alpha), w4, w1


class MaGGIe(nn.Module):
    """``cfg`` is the ``model`` subtree of the config.

    ``split_eval``: the eval forward is ``encode_frames`` then
    ``decode_window``, so streaming video eval may cache the first half
    (``engine/test.py::eval_video``); an arch whose forward is not that
    split clears it."""

    split_eval = True

    def __init__(self, cfg):
        super().__init__()
        from . import build_decoder, build_encoder
        self.num_masks = int(cfg["encoder_args"].get("num_mask", 1))
        enc_args = dict(cfg["encoder_args"])
        # the block-sparse decoder reads the os1 skip features only at selected
        # blocks: defer that encoder branch to patch domain unless overridden
        # (maggie_tpu/models/maggie.py:44-50)
        if (cfg["decoder"] in _SPARSE_DECODERS
                and cfg["decoder_args"].get("sparse_mode") == "block"
                and not cfg["decoder_args"].get("phase_rung", False)
                and "lazy_os1_shortcut" not in enc_args
                and cfg["encoder"] in _LAZY_OS1_ENCODERS):
            enc_args["lazy_os1_shortcut"] = True
        # encoder_args.lazy_os2_shortcut runs the dense shortcut.1 (the same
        # numbers: models/__init__.py); the JAX package refuses it at eval off
        # block mode (maggie_tpu/models/decoder_sparse.py:514-515), and so does
        # the port
        self.lazy_os2_off_block = (bool(enc_args.get("lazy_os2_shortcut", False))
                                   and cfg["decoder"] in _SPARSE_DECODERS
                                   and cfg["decoder_args"].get("sparse_mode") != "block")
        self.encoder = build_encoder(cfg["encoder"], enc_args)
        if getattr(self.encoder, "returns_pyramid", False):
            # maggie_tpu/models/maggie.py:135 unpacks two values from it and fails
            raise ValueError(f"encoder {cfg['encoder']!r} returns the feature pyramid dict, "
                             f"which no harness takes (ROADMAP.md queue 3); use "
                             f"res_shortcut_embed_29 or res_shortcut_29")
        self.aspp = ASPP(cfg["aspp"]["in_channels"], cfg["aspp"]["out_channels"])
        self.decoder = build_decoder(cfg["decoder"], dict(cfg["decoder_args"]))
        self.compute_dtype = (torch.bfloat16 if str(cfg.get("precision", "fp32")) in
                              ("bf16", "bfloat16", "16") else torch.float32)
        self.loss_alpha_w = float(cfg.get("loss_alpha_w", 1.0))
        self.loss_alpha_type = cfg.get("loss_alpha_type", "l1")
        self.loss_alpha_lap_w = float(cfg.get("loss_alpha_lap_w", 1.0))
        self.loss_alpha_grad_w = float(cfg.get("loss_alpha_grad_w", 1.0))
        self.loss_atten_w = float(cfg.get("loss_atten_w", 1.0))
        self.reweight_os8 = bool(cfg.get("loss_reweight_os8", True))
        self.loss_dtssd_w = float(cfg.get("loss_dtSSD_w", 1.0))
        # "none" or "selective" (remat.py); the train step sets it for its forward
        self.remat = "none"

    def _inputs(self, batch: dict, train: bool, dtype: torch.dtype | None = None):
        """Compute-dtype (or ``dtype``) NCHW frames, masks at full size, and
        the encoder input (reference ``prepare_input``, :200-235): RGB | masks
        zero-padded up to ``num_masks`` slots. In train the padded masks (and
        alphas and transitions) replace the true ones."""
        x = batch["image"]                      # (b, n_f, H, W, 3)
        masks = batch["mask"]                   # (b, n_f, n_i, hm, wm)
        b, n_f, h, w, _ = x.shape
        n_i = masks.shape[2]
        dtype = self.compute_dtype if dtype is None else dtype
        x = x.reshape(b * n_f, h, w, 3).permute(0, 3, 1, 2).to(dtype)
        masks = masks.reshape((b * n_f, n_i) + masks.shape[-2:])
        if masks.shape[-1] != w:
            masks = resize_nearest(masks, (h, w))
        masks = masks.to(x.dtype)
        gt = {}
        if train:
            if self.num_masks > 0 and n_i > self.num_masks:
                # the JAX package fails here too, at init or at the encoder's
                # input width (ROADMAP.md queue 3)
                raise ValueError(
                    f"the train batch has {n_i} instance slots but the model takes "
                    f"encoder_args.num_mask {self.num_masks}: set dataset.train.max_inst "
                    f"to at most {self.num_masks}")
            gt = {k: batch[k].reshape(b * n_f, n_i, h, w) for k in ("alpha", "transition")}
        inp = x
        if self.num_masks > 0:
            inp_masks = masks
            if self.num_masks > n_i:
                pad = masks.new_zeros((b * n_f, self.num_masks - n_i, h, w))
                inp_masks = torch.cat([masks, pad], dim=1)
                if train:
                    masks = inp_masks
                    gt = {k: torch.cat([v, v.new_zeros((b * n_f, self.num_masks - n_i, h, w))], 1)
                          for k, v in gt.items()}
                    n_i = self.num_masks
            inp = torch.cat([x, inp_masks], dim=1)
        return inp, masks, gt, (b, n_f, n_i, h, w)

    def forward(self, batch: dict, use_mask_atten: bool = False, use_gt_guidance: bool = False,
                use_prm_weights: bool = True, atten_loss_enabled: bool = True,
                generator: torch.Generator | None = None, mem_feat=None, prev_pred=None):
        if not self.training:
            return self._eval_forward(batch, mem_feat, prev_pred)
        try:
            return self._train_forward(batch, use_mask_atten, use_gt_guidance, use_prm_weights,
                                       atten_loss_enabled, generator)
        finally:
            end_sn_chains(self)

    def _train_forward(self, batch, use_mask_atten, use_gt_guidance, use_prm_weights,
                       atten_loss_enabled, generator):
        """The train forward as the stages of selective remat (``remat.py``):
        each in a checkpoint segment of its own when ``self.remat`` is
        ``"selective"`` (the train step sets it), else called as it is. With
        a dense decoder (``res_shortcut_22``, ``res_shortcut_inst_matt_22``),
        which tags nothing in the JAX package, stages 3-6 are one: the
        decoder, the fusion and the losses."""
        if space.banded():
            self.check_rows()
        inp, masks, gt, dims = self._inputs(batch, train=True)
        run = remat.Stages(self.remat == "selective", generator)
        out, *feas = run(self._train_encode, inp)                          # stage 1
        with parallel.replicated():
            embedding = run(self.aspp, out)                                 # stage 2
        finish = functools.partial(self._train_loss, gt=gt, dims=dims,
                                   use_prm_weights=use_prm_weights,
                                   atten_loss_enabled=atten_loss_enabled, generator=generator)
        step = TrainStep(dims[0], dims[1], masks, gt["alpha"], gt["transition"], use_mask_atten,
                         use_gt_guidance, generator, finish=finish)
        return self.decoder.train_forward(run, embedding, feas, step)      # stages 3-6

    def check_rows(self) -> None:
        """ValueError unless this model's train step runs row-sharded
        (``parallel/space.py``): the flagship image arch or the video arch
        (``MaGGIeTemp``) with its own decoder and the block ladder, without
        remat. Other archs and decoders, the oracle ladder and eval are not
        yet sharded."""
        from .decoder_sparse import ResShortCutInstMattSpconvDec
        from .decoder_video import ResShortCutInstMattSpconvTempDec
        from .maggie_temp import MaGGIeTemp
        sharded = {MaGGIe: ResShortCutInstMattSpconvDec,
                   MaGGIeTemp: ResShortCutInstMattSpconvTempDec}
        why = None
        if sharded.get(type(self)) is not type(self.decoder):
            why = f"arch {type(self).__name__} with decoder {type(self.decoder).__name__}"
        elif self.decoder.sparse_mode != "block":
            why = f"the {self.decoder.sparse_mode!r} ladder"
        elif self.remat != "none":
            why = f"model.remat {self.remat}"
        elif not self.training:
            why = "eval"
        if why is not None:
            raise ValueError(f"row sharding (space {parallel.space_world()}) runs the MaGGIe "
                             f"image and video train steps with the block ladder and "
                             f"model.remat none; {why} is not yet sharded")

    def _train_encode(self, inp: torch.Tensor):
        """Stage 1: the encoder's trunk output and its five shortcut features."""
        out, mid_fea = self.encoder(inp)
        return (out, *mid_fea["shortcut"])

    def fuse(self, pred: dict, generator: torch.Generator | None = None):
        """PRM fusion of a decoder without its own (``prm_fuse``)."""
        return prm_fuse(pred["alpha_os8"], pred["alpha_os4"], pred["alpha_os1"], self.training,
                        generator)

    def _train_loss(self, pred: dict, gt: dict, dims, use_prm_weights: bool,
                    atten_loss_enabled: bool, generator: torch.Generator | None = None):
        """The end of the last stage: ``(output, loss_dict)`` from the
        decoder's train result, fused here when the decoder has no fusion
        of its own (its weights are then the fusion's bands)."""
        b, n_f, n_i, h, w = dims
        if "refined_masks" not in pred:
            alpha_pred, weight_os4, weight_os1 = self.fuse(pred, generator)
            pred = {**pred, "refined_masks": alpha_pred}
        else:
            alpha_pred = pred["refined_masks"]
            if use_prm_weights:
                weight_os4, weight_os1 = pred["weight_os4"], pred["weight_os1"]
            else:
                weight_os4 = weight_os1 = pred["detail_mask"].to(alpha_pred.dtype)
        output = self._transform_output(pred, b, n_f, n_i, h, w)
        output = {k: v for k, v in output.items() if not k.startswith("mem_")}
        valid = (space.frame_sum(gt["transition"]) > 0).float()
        alphas = {k: pred[k] * valid for k in _ALPHAS}
        loss_dict = self.compute_loss(alphas, weight_os4, weight_os1, gt["alpha"],
                                      (b, n_f, self.num_masks, h, w))
        if "loss_max_atten" in pred and self.loss_atten_w > 0 and atten_loss_enabled:
            atten = pred["loss_max_atten"]
            atten = atten if torch.is_tensor(atten) else alpha_pred.new_tensor(atten)
            # a replicated stage's term: once in the total under row sharding
            loss_dict["loss_max_atten"] = space.replicated_term(atten)
            loss_dict["total"] = loss_dict["total"] + loss_dict["loss_max_atten"] * self.loss_atten_w
        self._extra_losses(pred, loss_dict)
        return output, loss_dict

    def _extra_losses(self, pred: dict, loss_dict: dict) -> None:
        """Hook for the video arch's temporal losses (reference
        ``update_additional_decoder_loss``)."""

    # ----- eval: the frame-local half and the decoder half -----
    # The encoder and ASPP are frame-local (2-D convs; all temporal mixing is
    # in the decoder), so streaming video eval encodes only the frames a
    # window adds and rolls the rest of the feature pack from the previous
    # window (``maggie_tpu/models/maggie.py:201-278``). The eval forward is
    # the same two halves on one batch.

    @torch.no_grad()
    def encode_frames(self, batch: dict) -> dict:
        """Input prep, encoder and ASPP of ``batch``'s frames. Returns a pack
        of tensors whose first dim is the frame (``embedding``, ``fea2`` to
        ``fea5``, ``fea1`` or, with the lazy os1 shortcut, its input ``inp``,
        ``image``, and the full-size guidance ``masks``), which
        ``decode_window`` reads; packs of consecutive frames concatenate.

        The frames are encoded one at a time: a conv library may pick another
        algorithm for another batch size (oneDNN on the CPU does, for the
        deeper maps), and a frame's features must not depend on the window
        that encoded it for a rolled pack to equal a fresh one bit for bit."""
        if self.lazy_os2_off_block:
            raise ValueError("lazy os2 shortcut requires sparse_mode='block'")
        if parallel.space_world() > 1:
            self.check_rows()
        inp, masks, _, _ = self._inputs(batch, train=False)
        packs = [self._encode(inp[i:i + 1]) for i in range(inp.shape[0])]
        feats = {k: torch.cat([p[k] for p in packs]) if len(packs) > 1 else packs[0][k]
                 for k in packs[0]}
        feats["masks"] = masks
        return feats

    def _encode(self, inp: torch.Tensor) -> dict:
        embedding, mid_fea = self.encoder(inp)
        fea1, fea2, fea3, fea4, fea5 = mid_fea["shortcut"]
        feats = {"embedding": self.aspp(embedding), "fea2": fea2, "fea3": fea3, "fea4": fea4,
                 "fea5": fea5, "image": mid_fea["image"]}
        if fea1 is not None:
            feats["fea1"] = fea1
        if "shortcut0_input" in mid_fea:
            feats["inp"] = mid_fea["shortcut0_input"]
        return feats

    @torch.no_grad()
    def decode_window(self, feats: dict, prev_pred=None, mem_feat=None) -> dict:
        """The decoder half over the pack of one clip window (b = 1): equal to
        the eval forward on the same frames."""
        n_f, n_i, h, w = feats["masks"].shape
        return self._decode(feats, 1, n_f, n_i, h, w, mem_feat, prev_pred)

    @torch.no_grad()
    def _eval_forward(self, batch: dict, mem_feat=None, prev_pred=None) -> dict:
        b, n_f, h, w, _ = batch["image"].shape
        return self._decode(self.encode_frames(batch), b, n_f, batch["mask"].shape[2], h, w,
                            mem_feat, prev_pred)

    def _decode(self, feats, b, n_f, n_i, h, w, mem_feat, prev_pred) -> dict:
        mid_fea = {"shortcut": (feats.get("fea1"), feats["fea2"], feats["fea3"], feats["fea4"],
                                feats["fea5"]),
                   "image": feats["image"]}
        if "inp" in feats:
            mid_fea["shortcut0_fn"] = self.encoder.shortcut[0]
            mid_fea["shortcut0_input"] = feats["inp"]
        # only the video decoder takes a memory
        mem = {} if mem_feat is None else {"mem_feat": mem_feat}
        pred = self.decoder(feats["embedding"], mid_fea, b=b, n_f=n_f, n_i=n_i,
                            masks=feats["masks"], **mem)
        if "refined_masks" not in pred:
            pred["refined_masks"] = self.fuse(pred)[0]
        return self._finalize_eval(self._transform_output(pred, b, n_f, n_i, h, w), prev_pred)

    def _transform_output(self, pred: dict, b, n_f, n_i, h, w) -> dict:
        """The first ``n_i`` slots' outputs as (b, n_f, n_i, H, W) (the true
        instances in eval, every slot in train; ``detail_mask`` where the
        decoder gives one), and the decoder's memory (``mem_*``) as it is."""
        out = {k: pred[k][:, :n_i].reshape(b, n_f, n_i, h, w)
               for k in _ALPHAS + ("refined_masks", "detail_mask") if k in pred}
        out.update({k: v for k, v in pred.items() if k.startswith("mem_")})
        return out

    def _finalize_eval(self, output: dict, prev_pred) -> dict:
        """Hook for the video arch's temporal rule (``MaGGIeTemp``)."""
        return output

    def compute_loss(self, pred: dict, weight_os4, weight_os1, alphas, alpha_shape,
                     reweight_os8: bool | None = None) -> dict:
        """Reference ``compute_loss`` (maggie.py:268-368); ``pred`` holds the
        three alphas (b*n_f, n_i, H, W), ``alphas`` the GT; ``reweight_os8``
        overrides ``loss_reweight_os8``."""
        a1, a4, a8 = (pred[k] for k in _ALPHAS)
        valid = (space.frame_sum(alphas) > 0).float()
        weight_os8 = torch.ones_like(a8) * valid
        if self.reweight_os8 if reweight_os8 is None else reweight_os8:
            unk_gt = (alphas <= 254.0 / 255.0) & (alphas >= 1.0 / 255.0)
            unk_pred = (a8 <= 254.0 / 255.0) & (a8 >= 1.0 / 255.0)
            weight_os8 = (unk_gt | unk_pred).to(weight_os8.dtype) + weight_os8
        weights = (weight_os1, weight_os4, weight_os8)
        loss_dict, total = {}, 0.0

        def scales(name, fn, weight):
            terms = [fn(a, w) for a, w in zip((a1, a4, a8), weights)]
            loss_dict.update({f"{name}_os{s}": t for s, t in zip((1, 4, 8), terms)})
            loss_dict[name] = terms[0] * 2 + terms[1] + terms[2]
            return loss_dict[name] * weight

        if self.loss_alpha_w > 0:
            total = total + scales(
                "loss_rec", lambda a, w: regression_loss(a, alphas, self.loss_alpha_type, w),
                self.loss_alpha_w)
        if self.loss_alpha_lap_w > 0:
            hw = a8.shape[-2:]
            n1hw = lambda t: t.reshape((-1, 1) + hw)
            total = total + scales("loss_lap", lambda a, w: lap_loss(n1hw(a), n1hw(alphas), n1hw(w)),
                                   self.loss_alpha_lap_w)
        if self.loss_alpha_grad_w > 0:
            total = total + scales("loss_grad", lambda a, w: gradient_loss(a, alphas, w),
                                   self.loss_alpha_grad_w)
        if self.loss_dtssd_w > 0:
            r = lambda t: t.reshape(alpha_shape)
            total = total + scales("loss_dtSSD", lambda a, w: loss_dtssd(r(a), r(alphas), r(w)),
                                   self.loss_dtssd_w)
        loss_dict["total"] = total
        return loss_dict


class Dummy(nn.Module):
    """Passthrough arch (port of ``maggie_tpu/models/maggie.py::Dummy``;
    reference ``arch/dummy.py:3-9``): the prediction is the input mask,
    resized nearest to the image. It drives the engine, data and metric
    loops without a model. One inert ``scale`` parameter (0) gives the
    optimizer and the checkpoints something to hold; the train loss is zero.
    The train forward returns ``(output, {"total": 0})``."""

    split_eval = False

    def __init__(self, cfg=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(()))
        self.remat = "none"

    def init_params(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.zero_()

    def forward(self, batch: dict, use_mask_atten: bool = False, use_gt_guidance: bool = False,
                use_prm_weights: bool = True, atten_loss_enabled: bool = True,
                generator: torch.Generator | None = None, mem_feat=None, prev_pred=None):
        masks = batch["mask"]
        b, n_f, n_i = masks.shape[:3]
        h, w = batch["image"].shape[2:4]
        if masks.shape[-1] != w:
            m = resize_nearest(masks.reshape((b * n_f, n_i) + masks.shape[-2:]), (h, w))
            masks = m.reshape(b, n_f, n_i, h, w)
        m = masks.float()
        out = {"refined_masks": m, "alpha_os8": m}
        if self.training:
            return out, {"total": m.mean() * 0.0 + self.scale * 0.0}
        return out
