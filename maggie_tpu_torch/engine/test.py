"""Evaluation engine (port of ``maggie_tpu/engine/test.py``; reference
``maggie/engine/test.py``).

- ``eval_image``: per batch, the forward on the model's device -> reverse
  transform -> clamp at 1/255 and 254/255 -> optional largest-CC postprocess ->
  metric updates (reference ``test.py:99-165``);
- ``eval_video``: overlapping clip windows streamed through the video model,
  the previous window's alpha (and, with ``carry_memory``, its ConvGRU state)
  carried, the encoder features of the frames two windows share cached, and
  the reference's rolling metric windows (``test.py:169-296``);
- ``test``: dataset, model and metric assembly, the dispatch to
  ``eval_video`` for a VIM set, and the final cross-process gather
  (``test.py:299-371``).

The forward of batch (window) i+1 is launched before the host works on batch
i, as the JAX package's image loop does: ``refined_masks`` is copied to
pinned host memory behind a CUDA event, and the host waits on that event
only. Each sample runs at its own shape: the JAX package's shape bucketing is
a TPU workaround and is not ported (with it, padded instance slots change the
block capacity and so the numbers).
"""

from __future__ import annotations

import logging
import os
import time
from functools import partial

import numpy as np
import torch

from .. import parallel
from ..data import build_dataset
from ..data.loader import DataLoader
from ..device import resolve_device
from ..utils.memory import device_peak_memory_mb
from ..utils.meters import AverageMeter
from ..utils.metrics import build_metric
from ..utils.postprocess import postprocess, reverse_transform

logger = logging.getLogger(__name__)


def save_visualization(image_names, alpha_names, alphas, transform_info, output, save_dir):
    """Write per-instance alpha PNGs with PIL (reference ``test.py:21-68``)."""
    from PIL import Image
    for idx in range(len(image_names)):
        image_name = image_names[idx][0] if isinstance(image_names[idx], (list, tuple)) else image_names[idx]
        video_name, image_name = image_name.split("/")[-2:]
        out_dir = os.path.join(save_dir, video_name)
        os.makedirs(out_dir, exist_ok=True)
        alpha_pred = (alphas[0, idx] * 255).astype("uint8")
        for inst_id in range(alpha_pred.shape[0]):
            target = os.path.join(out_dir, image_name[:-4])
            if alpha_names is not None:
                target = os.path.join(target, alpha_names[inst_id][0]
                                      if isinstance(alpha_names[inst_id], (list, tuple))
                                      else alpha_names[inst_id])
            elif alpha_pred.shape[0] > 1:
                target = os.path.join(target, "{:02d}.png".format(inst_id))
            else:
                target = target + ".png"
            os.makedirs(os.path.dirname(target), exist_ok=True)
            Image.fromarray(alpha_pred[inst_id]).save(target)


def compute_metrics(all_preds, all_trimap, all_gts, val_error_dict,
                    prev_preds=None, prev_trimap=None, prev_gts=None):
    """Reference ``test.py:70-96``."""
    current = {}
    for k, v in val_error_dict.items():
        cur_preds, cur_gts = all_preds, all_gts
        if k in ("dtSSD", "MESSDdt"):
            if prev_preds is None:
                continue
            cur_preds = np.concatenate([prev_preds, all_preds], axis=0)
            cur_gts = np.concatenate([prev_gts, all_gts], axis=0)
        # reference: only the MAD region variants receive a trimap; every other
        # metric runs with trimap=None, i.e. a ones mask (test.py:86-93)
        cur_trimap = all_trimap if k.endswith(("_fg", "_bg", "_unk")) else None
        current[k] = v.update(cur_preds, cur_gts, trimap=cur_trimap)
    return current


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _host_copy(rm: torch.Tensor):
    """(host tensor, ready event or None): a card tensor's copy to pinned host
    memory rides behind the work queued so far; the host waits on the event."""
    if not rm.is_cuda:
        return rm, None
    host = torch.empty(rm.shape, dtype=rm.dtype, pin_memory=True)
    host.copy_(rm, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A batch array on ``dev``. A host array bound for the card goes through
    pinned memory, so that the copy queues behind the previous forward instead
    of waiting for it, as a copy from pageable memory would."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def eval_image(model, val_loader, log_iter, val_error_dict, do_postprocessing=False,
               callback=None):
    """Reference ``eval_image`` (test.py:99-165) on the model's device.

    Returns ``(batch_time, data_time, host_time)``, the averages over batches of:
    the forward, from its launch until ``refined_masks`` is on the host (as in
    the JAX package, that span also holds the host work on the previous batch
    and the wait for and launch of the next one, which the forward overlaps);
    the wait for the loader; and the host work after the forward (reverse
    transform, clamp, postprocess, metrics, callback)."""
    dev = _model_device(model)
    batch_time = AverageMeter("batch_time")
    data_time = AverageMeter("data_time")
    host_time = AverageMeter("host_time")
    end_time = time.time()
    pending = None  # (i, host copy, ready event, output, meta) awaiting host work

    def process(entry):
        i, alpha, ready, output, meta = entry
        image_names, alpha_names, ti, trimap, alpha_gt, skip, t_fwd = meta
        if ready is not None:
            ready.synchronize()
        alpha = alpha.numpy()
        batch_time.update(time.time() - t_fwd)
        t_host = time.time()
        alpha = reverse_transform(alpha, ti)
        alpha[alpha <= 1.0 / 255.0] = 0.0
        alpha[alpha >= 254.0 / 255.0] = 1.0
        if do_postprocessing:
            alpha = postprocess(alpha)
        current = compute_metrics(alpha[:, skip:], trimap[:, skip:],
                                  alpha_gt[:, skip:], val_error_dict)
        if i % log_iter == 0:
            s = f"Validation: Iter {i}/{len(val_loader)}: "
            s += ", ".join(f"{k} - {v:.4f}" for k, v in current.items())
            s += f", batch_time: {batch_time.avg:.4f}, data_time: {data_time.avg:.4f}"
            logger.info(s)
        if callback:
            callback(image_names, alpha_names, alpha, ti, output)
        host_time.update(time.time() - t_host)

    with torch.inference_mode():
        for i, batch in enumerate(val_loader):
            data_time.update(time.time() - end_time)
            image_names = batch.pop("image_names")
            alpha_names = batch.pop("alpha_names", None)
            transform_info = batch.pop("transform_info")
            trimap = np.asarray(batch.pop("trimap"))
            alpha_gt = np.asarray(batch.pop("alpha"))
            skip = int(np.asarray(batch.pop("skip"))[0])

            if float(batch["mask"].sum()) == 0:
                continue
            dbatch = {k: _to_device(batch[k], dev) for k in ("image", "mask")}

            t_fwd = time.time()
            output = model(dbatch)
            # the one tensor the host needs: its copy rides behind the forward
            # while the host works on the previous batch
            rm, ready = _host_copy(output["refined_masks"].float())
            ti = transform_info[0] if isinstance(transform_info, list) else transform_info
            meta = (image_names, alpha_names, ti, trimap, alpha_gt, skip, t_fwd)
            if pending is not None:
                process(pending)
            pending = (i, rm, ready, output, meta)
            end_time = time.time()

        if pending is not None:
            process(pending)
    return batch_time.avg, data_time.avg, host_time.avg


def eval_video(model, val_loader, log_iter, val_error_dict, do_postprocessing=False,
               callback=None, carry_memory=False, cache_features=True):
    """Reference ``eval_video`` (test.py:169-296) on the model's device, over a
    VIM set's overlapping clip windows (b = 1).

    Each window passes the previous window's frame-1 alpha (``prev_pred``) to
    the model's temporal rule; ``is_first`` resets it. The ConvGRU state is
    carried only with ``carry_memory`` (the state after the window's frame 0,
    which is the next window's first frame): the reference carries only tuple
    memory (``test.py:252-254``), so by default each window starts from a zero
    state. With ``cache_features`` the encoder and ASPP run only on the
    ``skip`` frames a window adds, and the feature pack of the others rolls
    over from the previous window (``MaGGIe.encode_frames`` /
    ``decode_window``); the result is the monolithic forward's bit for bit.
    A window without any mask is skipped, as in the reference, and the next
    one is encoded whole.

    The rolling metric windows replicate the reference's indexing
    (``test.py:262-274``), its last-window use of the previous window's
    ``prev_preds`` length included. Returns ``(batch_time, data_time,
    host_time)`` averaged over windows, as ``eval_image``'s."""
    dev = _model_device(model)
    batch_time = AverageMeter("batch_time")
    data_time = AverageMeter("data_time")
    host_time = AverageMeter("host_time")
    use_cache = bool(cache_features) and hasattr(model, "encode_frames")
    # device-side stream state, advanced as windows are launched
    mem_feats = prev_pred = feat_cache = None
    # host-side metric state, advanced as windows are processed, in order
    host = {"all_preds": None, "all_gts": None, "all_trimap": None, "names": [],
            "prev_preds": None}

    def process(entry):
        i, alpha, ready, meta = entry
        image_names, ti, trimap, alpha_gt, is_first, is_last, t_fwd = meta
        if ready is not None:
            ready.synchronize()
        alpha = alpha.numpy()
        batch_time.update(time.time() - t_fwd)
        t_host = time.time()
        alpha = reverse_transform(alpha, ti)
        alpha[alpha <= 1.0 / 255.0] = 0.0
        alpha[alpha >= 254.0 / 255.0] = 1.0
        if do_postprocessing:
            alpha = postprocess(alpha)
        h = host
        if is_first or h["all_preds"] is None:
            h["all_preds"], h["all_gts"], h["all_trimap"] = alpha[0], alpha_gt[0], trimap[0]
            h["names"] = list(image_names)
        else:
            h["all_gts"] = np.concatenate([h["all_gts"], alpha_gt[0, 2:]], axis=0)
            h["all_trimap"] = np.concatenate([h["all_trimap"], trimap[0, 2:]], axis=0)
            h["names"] += list(image_names[2:])
            h["all_preds"] = np.concatenate([h["all_preds"][:-1], alpha[0, 1:]], axis=0)
        all_preds, all_gts, all_trimap = h["all_preds"], h["all_gts"], h["all_trimap"]
        if callback is not None:
            end_idx = 1 if not is_last else len(all_preds)
            callback(h["names"][:end_idx], None, all_preds[None, :end_idx], ti, {})
        prev = h["prev_preds"]
        end_pred_idx = -3 if not is_last else (len(prev) if prev is not None else 0)
        if len(all_preds) > 3:
            prev_preds = all_preds[-4:end_pred_idx]
            prev_trimaps = all_trimap[-4:end_pred_idx]
            prev_gts = all_gts[-4:end_pred_idx]
        else:
            prev_preds = prev_trimaps = prev_gts = None
        h["prev_preds"] = prev_preds
        end_all_idx = -2 if not is_last else len(all_preds)
        current = compute_metrics(all_preds[-3:end_all_idx], all_trimap[-3:end_all_idx],
                                  all_gts[-3:end_all_idx], val_error_dict,
                                  prev_preds, prev_trimaps, prev_gts)
        video_name = image_names[0][0].split("/")[-2]
        logger.info(f"{video_name}: " + ", ".join(f"{k} - {v:.4f}" for k, v in current.items()))
        if len(all_preds) > 3:
            h["all_preds"], h["all_gts"] = all_preds[-3:], all_gts[-3:]
            h["all_trimap"], h["names"] = all_trimap[-3:], h["names"][-3:]
        if i % log_iter == 0:
            logger.info(f"Validation: Iter {i}/{len(val_loader)}: "
                        f"batch_time: {batch_time.avg:.4f}, data_time: {data_time.avg:.4f}")
        host_time.update(time.time() - t_host)

    pending = None
    end_time = time.time()
    with torch.inference_mode():
        for i, batch in enumerate(val_loader):
            data_time.update(time.time() - end_time)
            image_names = batch.pop("image_names")
            batch.pop("alpha_names", None)
            transform_info = batch.pop("transform_info")
            trimap = np.asarray(batch.pop("trimap"))
            alpha_gt = np.asarray(batch.pop("alpha"))
            is_first = bool(np.asarray(batch.pop("is_first"))[0])
            is_last = bool(np.asarray(batch.pop("is_last"))[0])
            skip = int(np.asarray(batch.pop("skip"))[0])
            if is_first:
                mem_feats = prev_pred = feat_cache = None
            if float(batch["mask"].sum()) == 0:
                feat_cache = None
                end_time = time.time()
                continue
            dbatch = {k: _to_device(batch[k], dev) for k in ("image", "mask")}

            t_fwd = time.time()
            if use_cache:
                n_f = dbatch["image"].shape[1]
                if feat_cache is not None and 0 < skip < n_f:
                    new = model.encode_frames({k: v[:, skip:] for k, v in dbatch.items()})
                    feat_cache = {k: torch.cat([feat_cache[k][n_f - skip:], new[k]])
                                  for k in feat_cache}
                else:
                    feat_cache = model.encode_frames(dbatch)
                output = model.decode_window(feat_cache, prev_pred=prev_pred, mem_feat=mem_feats)
            else:
                output = model(dbatch, prev_pred=prev_pred, mem_feat=mem_feats)
            alpha_dev = output["refined_masks"]
            prev_pred = alpha_dev[:, 1]
            mf = output.get("mem_feat")
            if carry_memory and mf is not None:
                mem_feats = mf[:, 0]
            rm, ready = _host_copy(alpha_dev.float())
            ti = transform_info[0] if isinstance(transform_info, list) else transform_info
            meta = (image_names, ti, trimap, alpha_gt, is_first, is_last, t_fwd)
            if pending is not None:
                process(pending)
            pending = (i, rm, ready, meta)
            end_time = time.time()
        if pending is not None:
            process(pending)
    return batch_time.avg, data_time.avg, host_time.avg


def eval_metrics(names: list[str]) -> dict:
    """The metrics ``test`` reports: ``names``, and with MAD its three trimap
    regions (``maggie_tpu/engine/test.py:412-417``)."""
    val_error_dict = build_metric(names)
    if "MAD" in val_error_dict:
        from ..utils.metrics import MAD_bg, MAD_fg, MAD_unk
        val_error_dict["MAD_fg"] = MAD_fg()
        val_error_dict["MAD_bg"] = MAD_bg()
        val_error_dict["MAD_unk"] = MAD_unk()
    return val_error_dict


def test(cfg, model=None, device=None):
    """Reference ``test`` (test.py:299-371). Returns the metric dict.

    ``model``: an eval-ready model (weights loaded, spectral norm folded); when
    None, the model of ``cfg.model`` is built, ``cfg.model.weights`` loaded and
    spectral norm folded (``pretrained.from_pretrained``), on ``device`` (CUDA
    unless the caller passes "cpu"; raises without a GPU)."""
    from ..pretrained import from_pretrained

    dev = resolve_device(device) if model is None else _model_device(model)
    logger.info("Creating testing dataset...")
    val_dataset = build_dataset(cfg, is_train=False, device=dev)
    nproc, pid = parallel.world(), parallel.rank()
    val_loader = DataLoader(val_dataset, batch_size=cfg.test.batch_size,
                            num_shards=nproc, shard_index=pid)

    logger.info("Building model...")
    if model is None:
        model, _ = from_pretrained(cfg.model.weights, config=cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"Number of parameters: {n_params}")

    val_error_dict = eval_metrics(cfg.test.metrics)
    logger.info("Start testing...")
    callback = (partial(save_visualization, save_dir=cfg.test.save_dir)
                if cfg.test.save_results else None)
    if cfg.dataset.test.name == "VIM":
        batch_time, data_time, _ = eval_video(
            model, val_loader, cfg.test.log_iter, val_error_dict,
            do_postprocessing=cfg.test.postprocessing, callback=callback,
            carry_memory=bool(cfg.test.get("carry_memory", False)),
            cache_features=bool(cfg.test.get("cache_features", True)))
    else:
        batch_time, data_time, _ = eval_image(model, val_loader, cfg.test.log_iter,
                                              val_error_dict,
                                              do_postprocessing=cfg.test.postprocessing,
                                              callback=callback)
    logger.info("Testing done!")
    peak_mb = device_peak_memory_mb(dev)
    if peak_mb is not None:
        logger.info(f"Maximum device memory: {peak_mb:.2f} MB")

    for v in val_error_dict.values():
        v.gather_metric()

    results = {}
    if pid == 0:
        metric_str = ""
        for k, v in val_error_dict.items():
            results[k] = v.average()
            metric_str += f"{k}: {v.average()}\n"
        logger.info("Metrics:\n" + metric_str)
        logger.info(",".join(str(v.average()) for v in val_error_dict.values()) + ",")
        logger.info(f"batch_time: {batch_time:.4f}, data_time: {data_time:.4f}")
    return results
