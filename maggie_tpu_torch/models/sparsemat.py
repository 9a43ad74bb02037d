"""SparseMat baseline (port of ``maggie_tpu/models/sparsemat.py``; reference
``maggie/network/arch/sparse_mat.py``), arch ``SparseMat`` and
``SparseMat_SingInst``.

The LPN (``lpn.py``) runs on the frame and its mask at ``shm.lr_scale``
(0.5), padded to a multiple of 64 at the bottom and right; its alpha,
resized x2 and cropped to the frame, is the low-resolution prediction.
The uncertain pixels of that prediction (0.01 < a < 0.99), dilated by a
square max pool of ``shm.dilation_kernel`` (15), are the active set over
which the SHM (``shm.py``, dense-masked) refines; the result is the SHM's
last head inside the set and the low-resolution prediction outside it.

Eval streams over the frames of a clip (reference ``forward_inference``,
``:89-120``): a later frame whose pixels barely changed from the frame
before (``generate_sparsity_map``) keeps the previous output there.

Train mode returns ``(output, loss_dict)``: L1, Laplacian and gradient
losses over the four heads, each resized to full size and combined with the
low-resolution prediction (``compute_loss``); the forward draws no random
numbers, and its BatchNorm and masked BatchNorm statistics step as in the
JAX package. The reference's 1.6M-pixel training cap is dropped, as in the
JAX package (a CUDA memory guard of the gathered form). ``loss_dtSSD_w``
is never read, as in the JAX package.

Inputs as the MaGGIe harness's: ``batch['image']`` (b, n_f, H, W, 3),
``batch['mask']`` (b, n_f, n_i, hm, wm), in training ``batch['alpha']``.
As in the JAX package, SparseMat reads no ``model.precision``: it runs in
f32 under ``--precision 16`` too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from .losses import gradient_loss, lap_loss
from .lpn import LPN
from .mgm_wrappers import one_instance_at_a_time
from .shm import SHM
from ..ops.resize import resize_bilinear


def maxpool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxPool2d(k, stride 1, padding k // 2) of (N, 1, H, W) maps; the
    padding never wins (the JAX package's ``reduce_window`` pads with -inf)."""
    return F.max_pool2d(x, k, 1, k // 2)


def box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k sum with zero padding of (N, 1, H, W) maps."""
    return F.avg_pool2d(x, k, 1, k // 2, count_include_pad=True) * float(k * k)


def reshape_lr(maps: torch.Tensor, scale: float, multiple: int = 64) -> torch.Tensor:
    """Reference ``reshape5D`` (:18-27): bilinear resize of the last two dims
    to ``int(size * scale)``, then zero padding at the bottom and right to a
    multiple of ``multiple``."""
    h, w = maps.shape[-2:]
    nh, nw = int(h * scale), int(w * scale)
    y = resize_bilinear(maps.float(), (nh, nw))
    return F.pad(y, (0, (multiple - nw % multiple) % multiple,
                     0, (multiple - nh % multiple) % multiple))


class SparseMat(nn.Module):
    """``cfg`` is the ``model`` subtree of the config."""

    split_eval = False       # eval_video runs the whole forward on every window
    remat_supported = False  # ROADMAP.md queue 1 item 12e

    def __init__(self, cfg):
        super().__init__()
        self.num_masks = int(cfg["encoder_args"].get("num_mask", 1))
        self.lpn = LPN(3 + self.num_masks, int(cfg["encoder_args"].get("mid_chn", 32)))
        self.shm = SHM(4)
        self.lr_scale = float(cfg["shm"]["lr_scale"])
        self.kernel = int(cfg["shm"]["dilation_kernel"])
        self.loss_alpha_w = float(cfg.get("loss_alpha_w", 1.0))
        self.loss_alpha_lap_w = float(cfg.get("loss_alpha_lap_w", 1.0))
        self.loss_alpha_grad_w = float(cfg.get("loss_alpha_grad_w", 1.0))

    def dilate(self, alpha: torch.Tensor) -> torch.Tensor:
        """The uncertain pixels (0.01 < a < 0.99), max-pooled."""
        return maxpool_same(((alpha > 0.01) & (alpha < 0.99)).float(), self.kernel)

    def generate_sparsity_map(self, lr_pred, curr_img, last_img):
        """Reference ``:240-255``: the active set of frames that follow
        another, from the uncertain pixels and the pixels that changed.
        ``shared`` marks where the frame equals the previous one: a mean
        change under 0.001 at the pixel and a 9x9 sum of it under 0.05.
        lr_pred (N, 1, H, W), images (N, 3, H, W). Returns (mask, mask_s,
        mask_t, shared)."""
        mask_s = self.dilate(lr_pred)
        diff = (curr_img - last_img).abs().mean(dim=1, keepdim=True)
        shared = ((box_sum(diff, 9) < 0.05) & (diff < 0.001)).float()
        mask_t = maxpool_same(1 - shared, self.kernel)
        mask = maxpool_same(mask_s * mask_t, self.kernel)
        return mask, mask_s, mask_t, shared

    def _run_shm(self, img, lr_pred, mask, ctx):
        """Dense-masked ``generate_sparse_inputs`` and the SHM (:60-74)."""
        x = torch.cat([img, (lr_pred - 0.5) / 0.5], dim=1)
        return self.shm(x * mask, lr_pred, mask, ctx)

    def _lr_pass(self, batch: dict):
        """The LPN at the low resolution: frames (N, 3, H, W) f32, the
        low-resolution alpha at (N, 1, H, W) f32, the context, and the
        clip's sizes."""
        image, masks = batch["image"], batch["mask"]
        b, n_f, h, w, _ = image.shape
        n_i = masks.shape[2]
        if n_i > self.num_masks:
            hint = ("set dataset.train.max_inst to at most " if self.training
                    else "run one mask at a time (arch SparseMat_SingInst) or set at most ")
            raise ValueError(f"the batch has {n_i} instance slots but the model takes "
                             f"encoder_args.num_mask {self.num_masks}: {hint}{self.num_masks}")
        img = image.reshape(b * n_f, h, w, 3).permute(0, 3, 1, 2).float()
        masks = masks.reshape((b * n_f, n_i) + masks.shape[-2:])
        lr_img = reshape_lr(img, self.lr_scale)
        lr_mask = reshape_lr(masks, self.lr_scale / (masks.shape[-1] / w))
        lr_pred, ctx = self.lpn(torch.cat([lr_img, lr_mask], dim=1))
        lr_pred = resize_bilinear(lr_pred, (lr_pred.shape[-2] * 2, lr_pred.shape[-1] * 2))
        return img, lr_pred[..., :h, :w], ctx, (b, n_f, h, w)

    def forward(self, batch: dict, generator: torch.Generator | None = None, **_unused):
        if not self.training:
            return self._eval_forward(batch)
        img, lr_pred, ctx, (b, n_f, h, w) = self._lr_pass(batch)
        mask = self.dilate(lr_pred)
        preds = self._run_shm(img, lr_pred, mask, ctx)
        final = preds[-1] * mask + lr_pred * (1 - mask)
        output = {"refined_masks": final.reshape(b, n_f, -1, h, w)}
        return output, self.compute_loss(preds, lr_pred, batch["alpha"], mask)

    @torch.no_grad()
    def _eval_forward(self, batch: dict) -> dict:
        """Streaming fusion (reference ``forward_inference``, :89-120) over
        the b * n_f frames."""
        img, lr_pred, ctx, (b, n_f, h, w) = self._lr_pass(batch)
        n = lr_pred.shape[0]
        if n > 1:
            mask_rest, _, _, shared = self.generate_sparsity_map(lr_pred[1:], img[1:], img[:-1])
            mask = torch.cat([self.dilate(lr_pred[:1]), mask_rest])
        else:
            mask, shared = self.dilate(lr_pred), None
        preds = self._run_shm(img, lr_pred, mask, ctx)[-1]
        outs = [preds[:1] * mask[:1] + lr_pred[:1] * (1 - mask[:1])]
        for i in range(1, n):
            m, s = mask[i:i + 1], shared[i - 1:i]
            outs.append(preds[i:i + 1] * m + lr_pred[i:i + 1] * (1 - m) * (1 - s)
                        + outs[-1] * (1 - m) * s)
        return {"refined_masks": torch.cat(outs).reshape(b, n_f, -1, h, w)}

    def compute_loss(self, preds: list, lr_pred, alphas, mask) -> dict:
        """Reference ``compute_loss`` (:186-238): each head resized to full
        size and combined with ``lr_pred`` outside ``mask``; L1, Laplacian
        and gradient terms weighted 2, 1, .5, .25 from the last head back."""
        h, w = alphas.shape[-2:]
        a = alphas.reshape(-1, 1, h, w).float()
        combined = [(p if p.shape[-1] == w else resize_bilinear(p, (h, w))) * mask
                    + lr_pred * (1 - mask) for p in preds]

        def weighted(fn):
            total, weight = 0.0, 2.0
            for p in combined[::-1]:
                total = total + weight * fn(p, a)
                weight /= 2.0
            return total

        loss_dict, total = {}, 0.0
        for name, w_term, fn in (
                ("loss_rec", self.loss_alpha_w, lambda p, t: parallel.global_mean((p - t).abs())),
                ("loss_lap", self.loss_alpha_lap_w, lap_loss),
                ("loss_grad", self.loss_alpha_grad_w, gradient_loss)):
            if w_term > 0:
                loss_dict[name] = weighted(fn)
                total = total + loss_dict[name] * w_term
        loss_dict["total"] = total
        return loss_dict


class SparseMatSingInst(SparseMat):
    """In eval, one instance mask at a time, the outputs concatenated on the
    instance axis (reference ``SparseMat_SingInst``, :257-272); in train the
    plain forward."""

    @torch.no_grad()
    def _eval_forward(self, batch: dict) -> dict:
        return one_instance_at_a_time(super()._eval_forward, batch)
