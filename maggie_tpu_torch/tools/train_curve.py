"""Block-ladder against oracle-ladder training curves (port of
``tools/train_curve.py``).

The same model (seed 0) trains for ``iters`` iterations with the dense
oracle ladder and with the fixed-capacity block ladder, on one stream of
synthetic scenes (``make_batch``: ``cap_quality.procedural_alpha``'s
figures over a flat noise frame, guidance masks from the alphas at 1/8),
the step generator seeded alike before every step. Both loss curves go to
a JSON file; the closing line gives each curve's mean over its last tenth,
their largest gap and their correlation. One step's agreement with the JAX
package is held elsewhere (``tests/test_torch_train.py``,
``tests/test_torch_remat.py``); this shows whether dropping blocks at the
capacity, with BatchNorm statistics over the kept cores, trains alike over
hundreds of steps.

    python -m maggie_tpu_torch.tools.train_curve [iters] [size] [out.json] [cap_frac] [--device cpu]

Defaults 300 iterations at 192x192, ``output/torch_port/train_curve.json``,
capacity 0.5, on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .cap_quality import procedural_alpha

FLAGS = dict(use_mask_atten=False, use_gt_guidance=False, use_prm_weights=True,
             atten_loss_enabled=True)
# every step's generator seed (the JAX tools pass PRNGKey(7) to every step);
# the generator is the host's on the card too, so a card run draws what a
# CPU run draws (the dilations' random widths; the dropouts are off)
STEP_SEED = 7


def make_batch(seed: int, h: int, w: int, n_i: int = 3) -> dict:
    """One frame of ``n_i`` figures as numpy arrays (b = n_f = 1): the image,
    the guidance masks (alphas above 0.5 at every 8th pixel), the alphas and
    their transition band (0.05 < alpha < 0.95)."""
    rs = np.random.RandomState(seed)
    alpha = procedural_alpha(seed, h, w, n_i=n_i)
    fg = rs.rand(h, w, 3).astype(np.float32)
    comp = fg * 0.5 + 0.25
    mask = (alpha[:, ::8, ::8] > 0.5).astype(np.float32)
    trans = ((alpha > 0.05) & (alpha < 0.95)).astype(np.float32)
    return {"image": comp[None, None], "mask": mask[None, None], "alpha": alpha[None, None],
            "transition": trans[None, None]}


def study_cfg(sparse_mode: str, cap_frac: float, max_iter: int, warmup_iters: int,
              precision: str = "fp32"):
    """The studies' model: the flagship at attention and final width 32
    (``dryrun.image_model_cfg``), dropouts off, AdamW 1.5e-4 on a cosine
    schedule."""
    from ..dryrun import image_model_cfg
    cfg = image_model_cfg(atten_dim=32, final_channel=32)
    cfg.model.precision = precision
    cfg.model.decoder_args.update(dict(sparse_mode=sparse_mode, block_cap_frac=cap_frac,
                                       inst_spec_dropout=0.0, detail_mask_dropout=0.0))
    cfg.train.optimizer.name = "adamw"
    cfg.train.optimizer.lr = 1.5e-4
    cfg.train.scheduler.name = "cosine"
    cfg.train.max_iter = max_iter
    cfg.train.scheduler.warmup_iters = warmup_iters
    return cfg


def on_device(batch: dict, device) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def trainer(cfg, device, remat: str = "none"):
    """(state, step) of the study model built from seed 0 in train mode."""
    from ..dryrun import _model
    from ..engine.optim import build_optimizer
    from ..engine.train_step import TrainState, make_train_step
    model = _model(cfg, device, seed=0).train()
    optimizer, schedule = build_optimizer(cfg, model.parameters())
    return TrainState(model, optimizer), make_train_step(model, optimizer, schedule, remat=remat)


def run(sparse_mode: str, iters: int, h: int, w: int, cap_frac: float, device,
        record: dict | None = None) -> list[float]:
    """The total loss of each of ``iters`` steps with the ``sparse_mode``
    ladder. ``record`` (a dict) receives each step's loss terms
    (``loss_dicts``) and seconds (``seconds``, the card synchronised)."""
    import torch
    cfg = study_cfg(sparse_mode, cap_frac, max(iters, 100), max(iters // 10, 1))
    state, step = trainer(cfg, device)
    gen = torch.Generator()
    losses = []
    for i in range(iters):
        batch = on_device(make_batch(i % 64, h, w), device)
        t0 = time.perf_counter()
        ld = step(state, batch, gen.manual_seed(STEP_SEED), **FLAGS)
        losses.append(float(ld["total"]))
        if record is not None:
            record.setdefault("seconds", []).append(time.perf_counter() - t0)
            record.setdefault("loss_dicts", []).append({k: float(v) for k, v in ld.items()})
        if i % 20 == 0:
            print(f"[{sparse_mode}] iter {i}: {losses[-1]:.4f}", flush=True)
    return losses


def summary(curves: dict, iters: int) -> str:
    o, b = np.array(curves["oracle"]), np.array(curves["block"])
    k = max(iters // 10, 1)
    return (f"final-{k} mean loss: oracle {o[-k:].mean():.4f} block {b[-k:].mean():.4f}; "
            f"max |gap| overall {np.abs(o - b).max():.4f}; corr {np.corrcoef(o, b)[0, 1]:.5f}")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=300)
    ap.add_argument("size", nargs="?", type=int, default=192)
    ap.add_argument("out", nargs="?", default="output/torch_port/train_curve.json")
    ap.add_argument("cap_frac", nargs="?", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="'cpu' for the plain twins; the card by default")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    device = resolve_device(args.device)
    curves = {m: run(m, args.iters, args.size, args.size, args.cap_frac, device)
              for m in ("oracle", "block")}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(curves, f)
    print(summary(curves, args.iters))
    return curves


if __name__ == "__main__":
    main()
