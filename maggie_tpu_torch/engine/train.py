"""Training engine (port of ``maggie_tpu/engine/train.py``; reference
``maggie/engine/train.py:115-348``).

An iteration-based loop with the reference's cadence: log every ``log_iter``,
validate every ``val_iter`` (best and last checkpoints), save the last state
every ``ckpt_iter`` as well, visualize every ``vis_iter`` under wandb; a
shape-tolerant pretrained load and resume. As in the JAX package:

- the random flags of each iteration (the 50% GT guidance after warmup and
  the 75% PRM-weights draw) come from a host ``RandomState(seed + 77)``, and
  the step's own draws (dropout, dilation widths) from a ``torch.Generator``
  on the device, seeded before each step from ``(seed + 1, step)`` as JAX
  folds the step into its key, so that a resumed run draws what an
  uninterrupted one draws at the same step;
- loss values are read on ``log_iter`` iterations only, so the card is not
  made to wait otherwise;
- the run's first iteration is left out of ``batch_time`` and ``data_time``,
  whose sustained averages go to ``train_meters.json``.

Validation runs ``eval_video`` over a VIM test set and ``eval_image``
otherwise (``maggie_tpu/engine/train.py:163-164``); the losses logged are
whatever the model's loss dict holds (the video model's temporal terms
``loss_temp``, ``loss_temp_bce`` and ``loss_temp_dtssd`` among them).

Unlike the JAX package, the model is built eagerly and needs no init batch,
so the train set's ``RandomState`` gives its samples to training alone.
Validation runs the UNFOLDED model in eval mode (sigma from the stored u/v,
running BatchNorm statistics, neither stepped) and returns it to train mode.
Checkpoints: ``last_state.pt`` (``utils/checkpoint.py::save_train_state``)
with ``best_score.txt``, ``last_step.txt`` and ``best_metrics.txt`` beside it,
and ``best_model.npz`` in the JAX package's variables layout.

Data parallel (``parallel/``; the CLI joins the group under ``torchrun``):
``cfg.train.batch_size`` is one host's batch, as in the JAX package, so a
rank takes ``batch_size / LOCAL_WORLD_SIZE`` rows (a ``ValueError`` where
that does not divide: a launched rank cannot sit idle), from the train set
sharded by global rank; the validation set is sharded under
``train.val_dist``. The logged losses are the global batch's. Every rank
makes the same best-score decision (the metrics are all-reduced); rank 0
alone writes the checkpoints, the sidecars and wandb, and every rank waits
for it after each save. A resume loads ``last_state.pt`` onto each rank's
own device.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time

import numpy as np
import torch

from .. import parallel
from ..data import build_dataset
from ..data.loader import DataLoader
from ..device import resolve_device
from ..models.remat import remat_mode
from ..utils.memory import device_peak_memory_mb
from ..utils.meters import AverageMeter
from ..utils.metrics import build_metric
from .infeed import DeviceInfeed
from .optim import build_optimizer
from .test import eval_image, eval_video
from .train_step import TrainState, make_train_step

logger = logging.getLogger(__name__)


def _wandb():
    """The ``wandb`` module, or None where it is not installed."""
    if importlib.util.find_spec("wandb") is None:
        return None
    import wandb
    return wandb


def _init_wandb(cfg, is_sweep: bool):
    """wandb ready to log, or None (reference tools/main.py:45-53: a sweep job's
    agent has already called ``init``; ``cfg.wandb.id`` resumes a run)."""
    wandb = _wandb()
    if wandb is None:
        return None
    try:
        if not is_sweep:
            kw = dict(project=cfg.wandb.project, entity=cfg.wandb.entity, name=cfg.name)
            if cfg.wandb.id:
                kw.update(id=cfg.wandb.id, resume="must")
            wandb.init(**kw)
        wandb.config.update(cfg.to_dict(), allow_val_change=True)
    except Exception as exc:  # offline host or no API key: logs only
        logger.warning(f"wandb unavailable ({exc}); continuing without it")
        return None
    return wandb


def step_seed(seed: int, step: int) -> int:
    """The seed of the draws of the update that starts at ``step``."""
    return int(np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0])


def train(cfg, device=None, use_wandb: bool | None = None, is_sweep: bool = False) -> TrainState:
    """Train ``cfg``'s model on ``device`` (CUDA unless the caller passes "cpu";
    raises without a GPU) for ``cfg.train.max_iter`` iterations; returns the
    final train state."""
    from ..models import build_model
    from ..utils.checkpoint import (partial_load, restore_train_state, save_train_state,
                                    save_variables_npz)

    dev = resolve_device(device)
    remat = remat_mode(cfg.model.get("remat", "none"))
    nproc, pid = parallel.world(), parallel.rank()
    rank_batch = parallel.rank_batch_size(cfg.train.batch_size, parallel.local_world())
    want_wandb = use_wandb if use_wandb is not None else cfg.wandb.use
    wandb = _init_wandb(cfg, is_sweep) if want_wandb and pid == 0 else None
    seed = cfg.train.seed if cfg.train.seed >= 0 else 2023

    logger.info("Creating train dataset...")
    train_dataset = build_dataset(cfg, is_train=True, random_seed=seed)
    train_loader = DataLoader(train_dataset, batch_size=rank_batch, shuffle=True,
                              drop_last=True, seed=seed, num_shards=nproc, shard_index=pid,
                              infinite=True)
    logger.info("Creating val dataset...")
    val_dataset = build_dataset(cfg, is_train=False, device=dev)
    val_loader = DataLoader(val_dataset, batch_size=cfg.test.batch_size,
                            num_shards=nproc if cfg.train.val_dist else 1,
                            shard_index=pid if cfg.train.val_dist else 0)

    logger.info("Building model...")
    model = build_model(cfg.model, device=dev,
                        generator=torch.Generator().manual_seed(seed)).train()
    optimizer, schedule = build_optimizer(cfg, model.parameters())
    state = TrainState(model, optimizer)
    logger.info(f"Number of trainable parameters: {sum(p.numel() for p in model.parameters())}")

    # pretrained weights (shape-tolerant partial load, reference train.py:171-180)
    weights = cfg.model.weights
    if weights and os.path.isfile(weights) and weights.endswith(".npz"):
        with np.load(weights, allow_pickle=False) as data:
            partial_load(model, dict(data.items()))
        logger.info(f"Loaded pretrained weights from {weights}")
    elif weights:
        logger.warning(f"model.weights {weights!r}: training loads only a JAX-layout .npz "
                       f"file; starting from the seeded init")

    it = 0
    best_score = 99999999999.0
    resumed = False
    if cfg.train.resume != "" or cfg.train.resume_last:  # reference train.py:182-190
        model_path = cfg.train.resume if cfg.train.resume != "" else cfg.output_dir
        last = os.path.join(model_path, "last_state.pt")
        if not os.path.isfile(last):
            raise ValueError(f"Cannot resume model from {model_path}")
        restore_train_state(last, state)
        it, resumed = state.step, True
        score = os.path.join(model_path, "best_score.txt")
        if os.path.exists(score):
            with open(score) as f:
                best_score = float(f.read().strip())
        logger.info(f"Resuming from iter {it}, best score {best_score}")

    train_step = make_train_step(model, optimizer, schedule, remat=remat)
    batch_time = AverageMeter("batch_time")
    data_time = AverageMeter("data_time")
    log_metrics: dict[str, AverageMeter] = {}

    val_error_dict = build_metric(cfg.train.val_metrics)
    assert val_error_dict, "No validation metrics found!"
    assert cfg.train.val_best_metric in val_error_dict, "Best validation metric not found!"

    dargs = cfg.model.decoder_args
    warmup_atten = int(dargs.get("warmup_mask_atten_iter", 4000))
    warmup_detail = int(dargs.get("warmup_detail_iter", 3000))
    host_rng = np.random.RandomState(seed + 77)
    generator = torch.Generator(device=dev)
    eval_fn = eval_video if cfg.dataset.test.name == "VIM" else eval_image
    out_dir = cfg.output_dir

    def save_last():   # rank 0
        save_train_state(os.path.join(out_dir, "last_state.pt"), state)
        with open(os.path.join(out_dir, "best_score.txt"), "w") as f:
            f.write(str(best_score))
        # progress sidecar for a supervisor's crash-loop detection
        with open(os.path.join(out_dir, "last_step.txt"), "w") as f:
            f.write(str(it))

    # a checkpoint cadence independent of validation (the reference saves only
    # at val_iter), and fault injection to test a restart
    ckpt_iter = int(cfg.train.get("ckpt_iter", 0))
    fault_iter = int(os.environ.get("MAGGIE_FAULT_INJECT_ITER", "0"))

    logger.info("Start training...")
    os.makedirs(out_dir, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    warmed = False
    end_time = time.time()
    infeed = DeviceInfeed(iter(train_loader), dev)
    try:
        while it < cfg.train.max_iter:
            batch, dbatch = next(infeed)
            data_time.update(time.time() - end_time)
            it += 1
            if fault_iter and it == fault_iter and not resumed:
                # fires only in a fresh run, so that a restart makes progress
                raise RuntimeError(f"fault injection at iter {it} (MAGGIE_FAULT_INJECT_ITER)")
            use_mask_atten = it < warmup_atten
            use_gt_guidance = bool(it < warmup_detail or
                                   (it < warmup_detail * 3 and host_rng.rand() < 0.5))
            use_prm_weights = bool(host_rng.rand() < 0.75)
            atten_loss_enabled = it >= warmup_atten

            generator.manual_seed(step_seed(seed, state.step))
            loss_dict = train_step(state, dbatch, generator, use_mask_atten=use_mask_atten,
                                   use_gt_guidance=use_gt_guidance,
                                   use_prm_weights=use_prm_weights,
                                   atten_loss_enabled=atten_loss_enabled)

            if it % cfg.train.log_iter == 0:
                host_losses = {k: float(v) for k, v in parallel.sum_values(loss_dict).items()}
                if not np.isfinite(host_losses["total"]):
                    logger.error(f"Iter {it}: non-finite loss {host_losses['total']}")
                for k, v in host_losses.items():
                    log_metrics.setdefault(k, AverageMeter(k)).update(v)
                lr = float(schedule(it))
                s = f"Iter: {it}/{cfg.train.max_iter}"
                s += "".join(f", {k}: {v.avg:.4f}" for k, v in log_metrics.items())
                s += (f", lr: {lr:.6f}, batch_time: {batch_time.avg:.4f}s, "
                      f"data_time: {data_time.avg:.4f}s")
                peak_mb = device_peak_memory_mb(dev)
                if peak_mb is not None:
                    s += f", max_mem: {peak_mb:.0f}MB"
                logger.info(s)
                if wandb is not None:
                    wandb.log({f"train/{k}": v.val for k, v in log_metrics.items()}
                              | {"train/lr": lr, "train/iter": it})

            batch_time.update(time.time() - end_time)
            if not warmed:
                # leave out the run's first iteration (kernel builds, allocator
                # warm-up); the JAX package resets at every iteration instead
                # (its count is 1 after each reset), so it never writes the
                # sidecar below
                batch_time.reset()
                data_time.reset()
                warmed = True

            if wandb is not None and it % cfg.train.vis_iter == 0:
                # an extra eval-mode forward of this batch (reference train.py:286-291)
                try:
                    from .vis import save_train_visualization
                    model.eval()
                    with torch.inference_mode():   # the batch without the train GT
                        out = model({k: dbatch[k] for k in ("image", "mask")})
                    path = save_train_visualization(dbatch, out, it, out_dir)
                    wandb.log({"train/vis": wandb.Image(path)}, commit=False)
                except Exception as exc:  # vis never stops training (the reference's try)
                    logger.warning(f"visualization failed at iter {it}: {exc}")
                finally:
                    model.train()

            if it % cfg.train.val_iter == 0:
                logger.info("Start validation...")
                for v in val_error_dict.values():
                    v.reset()
                model.eval()
                eval_fn(model, val_loader, cfg.test.log_iter, val_error_dict,
                        do_postprocessing=False, callback=None)
                model.train()
                if cfg.train.val_dist:
                    for v in val_error_dict.values():
                        v.gather_metric()
                # the same decision on every rank: the metrics are the same
                total_error = val_error_dict[cfg.train.val_best_metric].average()
                improved, previous = total_error < best_score, best_score
                if improved:
                    best_score = total_error
                if pid == 0:
                    logger.info("Validation:" + ", ".join(
                        f"{k}: {v.average():.4f}" for k, v in val_error_dict.items()))
                    if improved:
                        logger.info(f"Best score changed from {previous:.4f} to "
                                    f"{total_error:.4f}")
                        save_variables_npz(os.path.join(out_dir, "best_model.npz"), model)
                        with open(os.path.join(out_dir, "best_metrics.txt"), "w") as f:
                            f.write(f"iter: {it}\n")
                            for k, v in val_error_dict.items():
                                f.write(f"{k}: {v.average():.4f}\n")
                    if wandb is not None:
                        wandb.log({f"val/{k}": v.average() for k, v in val_error_dict.items()}
                                  | {"val/best_error": best_score, "val/iter": it})
                    logger.info("Saving the last model...")
                    save_last()
                parallel.barrier()
            elif ckpt_iter and it % ckpt_iter == 0:
                if pid == 0:
                    save_last()
                parallel.barrier()
            end_time = time.time()
    finally:
        infeed.close()

    # sustained-throughput sidecar, first iteration left out (the reference
    # prints these averages in its log, maggie/engine/train.py:192-218)
    if pid == 0 and batch_time.count > 0:
        meters = {
            "iters_measured": batch_time.count,
            "batch_size": rank_batch * nproc,   # the global batch
            "batch_time_avg_s": batch_time.avg,
            "data_time_avg_s": data_time.avg,
            "samples_per_sec_sustained": rank_batch * nproc / batch_time.avg,
            "infeed_stall_frac": data_time.avg / batch_time.avg,
            "peak_mem_mb": device_peak_memory_mb(dev),
        }
        with open(os.path.join(out_dir, "train_meters.json"), "w") as f:
            json.dump(meters, f, indent=1)
    return state
