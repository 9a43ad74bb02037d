"""Optimizer and learning-rate schedule (port of ``maggie_tpu/engine/optim.py``;
reference ``maggie/engine/optim.py:97-141``).

``build_lr_schedule`` gives the learning rate as a function of the update
count, starting at 0 for the first update (as optax counts):

- ``poly``: base * (1 - s / (max_iter + 1)) ** power;
- ``step``: base * gamma ** (s // step_size);
- ``warmup_decay``: linear warmup to base over ``warmup_iters``, then
  base * sqrt(warmup / s);
- ``cosine``: torch's OneCycleLR (div_factor 25, final_div_factor 1e4): a
  cosine ramp from base/25 up to base over ``warmup_iters - 1`` updates, then
  a cosine anneal to base/25/1e4 at ``max_iter - 1``.

``build_optimizer`` returns a ``torch.optim`` optimizer whose update is the
optax chain of the JAX package: ``sgd`` (momentum, weight decay added to the
gradient), ``adam`` (weight decay as L2 on the gradient, as torch's Adam) and
``adamw`` (decoupled: each update also subtracts lr * weight_decay * param).
torch and optax compute the same formulas in another rounding order. The
global gradient clip at norm 0.01 (``clip_by_global_norm``) is optax's:
g * 0.01 / |g| when |g| >= 0.01, with no epsilon, where
``torch.nn.utils.clip_grad_norm_`` would divide by |g| + 1e-6.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterable

import torch

CLIP_NORM = 0.01  # reference train loop, engine/train.py:273-274


def build_lr_schedule(cfg: Any) -> Callable[[int], float]:
    sc = cfg.train.scheduler
    base = float(cfg.train.optimizer.lr)
    max_iter = int(cfg.train.max_iter)
    name = sc.name
    if name == "poly":
        power = float(sc.power)
        return lambda step: base * (1.0 - step / (max_iter + 1)) ** power
    if name == "step":
        size, gamma = int(sc.step_size), float(sc.gamma)
        return lambda step: base * gamma ** (step // size)
    if name == "warmup_decay":
        warm = int(sc.warmup_iters)
        return lambda step: base * (step / warm if step < warm
                                    else math.sqrt(warm / max(step, 1.0)))
    if name == "cosine":
        warm = max(int(sc.warmup_iters), 1)
        initial = base / 25.0
        final = initial / 1e4
        up_steps = max(int(round(warm / max_iter * max_iter)) - 1, 1)
        down_len = max(max_iter - 1 - up_steps, 1)

        def cosine(step: int) -> float:
            if step <= up_steps:
                return initial + (base - initial) * 0.5 * (1 - math.cos(math.pi * min(step / up_steps, 1.0)))
            t = min(max((step - up_steps) / down_len, 0.0), 1.0)
            return final + (base - final) * 0.5 * (1 + math.cos(math.pi * t))
        return cosine
    raise NotImplementedError(f"scheduler {name}")


def build_optimizer(cfg: Any, params: Iterable[torch.nn.Parameter]
                    ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer over ``params``, schedule). The train step sets each update's
    learning rate from the schedule before it steps."""
    oc = cfg.train.optimizer
    schedule = build_lr_schedule(cfg)
    wd = float(oc.weight_decay)
    lr = schedule(0)
    name = oc.name
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=float(oc.momentum), weight_decay=wd)
    elif name == "adam":
        b1, b2 = (float(b) for b in oc.betas)
        opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=wd)
    elif name == "adamw":
        b1, b2 = (float(b) for b in oc.betas)
        opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8, weight_decay=wd)
    else:
        raise NotImplementedError(f"optimizer {name}")
    return opt, schedule


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float = CLIP_NORM) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place; returns the norm before clipping.
    The norm is taken in f32 on the device, and the scale is applied there
    too, so the step waits on no host read."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
