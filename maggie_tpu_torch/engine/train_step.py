"""The training step (port of ``maggie_tpu/engine/train_step.py``; reference
train-loop body ``maggie/engine/train.py:211-283``).

``TrainState`` is the JAX package's train state in PyTorch's terms: the
update count, the model (its parameters, its BatchNorm running statistics and
its spectral-norm u/v buffers) and the optimizer (its moments). A step
mutates them in place:

    model.train()
    optimizer, schedule = build_optimizer(cfg, model.parameters())
    state = TrainState(model, optimizer)
    step = make_train_step(model, optimizer, schedule, remat="none")
    loss_dict = step(state, batch, generator, use_mask_atten=False,
                     use_gt_guidance=False, use_prm_weights=True,
                     atten_loss_enabled=True)

One step: the train-mode forward and its loss (which also steps the BatchNorm
statistics and the spectral-norm u/v), the gradients, the global-norm clip at
0.01, the learning rate of this update count, and the optimizer's update. The
flags are the JAX package's static ones; ``generator`` (a ``torch.Generator``
on the model's device) feeds the forward's random draws. Every parameter gets
a gradient, zero where the loss does not reach it, so that decoupled weight
decay touches every parameter as optax's does.

Under data parallelism (``parallel/``; each rank holds its rows of the global
batch) the model's reductions are global, a rank's loss terms are its parts
of the global batch's loss (``parallel.sum_values`` adds them up), and the
gradients are summed over the ranks before the clip, so that every rank
clips and steps on the global gradient and holds the same parameters. The
step raises if the ranks disagree on the remat mode or the flags. Under row
sharding (``parallel/space.py``; each rank holds a band of its data shard's
frames) the sum of the gradients over every rank stays right: a replicated
stage's copies each carry their own ranks' losses (``space.gather_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn

from .. import parallel
from ..models.remat import checkpointed, remat_mode
from .optim import clip_by_global_norm_


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def batch_stats(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.named_buffers() if k.endswith(("running_mean", "running_var"))}

    def spectral(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in self.model.named_buffers() if k.endswith(("weight_u", "weight_v"))}


def compute_grads(model: nn.Module, batch: dict, generator: torch.Generator | None,
                  remat: bool | str = "none", **flags) -> dict:
    """The train-mode forward and backward: leaves every parameter's gradient
    in ``.grad`` (zeros where the loss does not reach it; summed over the
    ranks under data parallelism) and returns the loss dict, detached (this
    rank's parts of the loss terms). ``remat`` (``models/remat.py``):
    ``"full"`` runs the whole forward, losses included, in one checkpoint
    segment; ``"selective"`` has the model run its stages in segments of
    their own."""
    mode = remat_mode(remat)
    if parallel.space_world() > 1:
        check_rows(model, mode)
    model.zero_grad(set_to_none=True)
    model.remat = "selective" if mode == "selective" else "none"
    try:
        if mode == "full":
            _, loss_dict = checkpointed(model, batch, rng=generator, generator=generator,
                                        **flags)
        else:
            _, loss_dict = model(batch, generator=generator, **flags)
    finally:
        model.remat = "none"
    loss_dict["total"].backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    parallel.all_reduce_grads(list(model.parameters()))
    return {k: v.detach() for k, v in loss_dict.items()}


def check_rows(model: nn.Module, mode: str) -> None:
    """ValueError unless ``model``'s step runs row-sharded
    (``parallel/space.py``): the flagship image step at ``model.remat none``
    (``MaGGIe.check_rows``)."""
    check = getattr(model, "check_rows", None)
    if check is None or mode != "none":
        what = f"model.remat {mode}" if check is not None else f"arch {type(model).__name__}"
        raise ValueError(f"row sharding (space {parallel.space_world()}) runs the MaGGIe image "
                         f"train step with the block ladder and model.remat none; {what} is "
                         f"not yet sharded")
    check()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    schedule: Callable[[int], float], remat: bool | str = "none") -> Callable:
    """``step(state, batch, generator, *, use_mask_atten, use_gt_guidance,
    use_prm_weights, atten_loss_enabled) -> loss_dict`` for ``state.model``
    (``model``) and ``state.optimizer`` (``optimizer``). ``remat`` is
    ``cfg.model.remat``: ``"none"`` (or False), ``"full"`` (or True) or
    ``"selective"`` (``models/remat.py``); any other value raises. A remat
    step computes what a plain step computes: the recompute replays the
    first pass's draws, BatchNorm and spectral-norm steps; every arch takes
    every mode (each model's stages: ``models/remat.py``)."""
    mode = remat_mode(remat)
    params = list(model.parameters())

    def step(state: TrainState, batch: dict, generator: torch.Generator | None, *,
             use_mask_atten: bool = False, use_gt_guidance: bool = False,
             use_prm_weights: bool = True, atten_loss_enabled: bool = True) -> dict:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the train state holds another model or optimizer than the step")
        if not model.training:
            raise ValueError("the train step needs the model in train mode (model.train())")
        parallel.check_same("the train step's remat mode and flags",
                            (mode, use_mask_atten, use_gt_guidance, use_prm_weights,
                             atten_loss_enabled))
        loss_dict = compute_grads(model, batch, generator, mode, use_mask_atten=use_mask_atten,
                                  use_gt_guidance=use_gt_guidance,
                                  use_prm_weights=use_prm_weights,
                                  atten_loss_enabled=atten_loss_enabled)
        clip_by_global_norm_([p.grad for p in params])
        lr = schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        state.step += 1
        return loss_dict

    return step
