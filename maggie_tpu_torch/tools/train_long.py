"""Long-horizon training of the block ladder on synthetic scenes (port of
``tools/train_long.py``).

The block ladder alone at the production training condition (bf16,
``model.remat selective``, capacity 0.5) for ``iters`` iterations on
``train_curve.make_batch``'s scenes 0-63 in turn, with a held-out check
every ``val_every`` iterations and at the last: the eval forward of the
training model (its parameters, BatchNorm statistics and spectral u/v as
they stand, no folding) on 8 fixed scenes (seeds 1000-1007), MAD and MSE
against their alphas, x 1e3. It stops at the first non-finite loss and
writes the loss curve and the checks to a JSON file.

    python -m maggie_tpu_torch.tools.train_long [iters] [size] [out.json] [val_every] [--device cpu]

Defaults 2000 iterations at 192x192, ``output/torch_port/train_long.json``,
a check every 200, on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..ops.kernels import launch_counts
from .train_curve import FLAGS, STEP_SEED, make_batch, on_device, study_cfg, trainer

VAL_SCENES = 8


def validate(model, val_batches: list[dict]) -> tuple[float, float]:
    """Mean MAD and MSE x 1e3 of the eval forward on ``val_batches``; the
    model is back in train mode after."""
    import torch
    mads, mses = [], []
    model.eval()
    try:
        with torch.no_grad():
            for vb in val_batches:
                pred = model(vb)["refined_masks"].float().cpu().numpy()
                gt = vb["alpha"].float().cpu().numpy()
                mads.append(float(np.abs(pred - gt).mean() * 1e3))
                mses.append(float(((pred - gt) ** 2).mean() * 1e3))
    finally:
        model.train()
    return float(np.mean(mads)), float(np.mean(mses))


def run(iters: int, size: int, val_every: int, device, record: dict | None = None) -> dict:
    """The JSON's dict: ``losses``, ``val`` (iteration, MAD and MSE x 1e3,
    loss), ``iters``, ``size``. ``record`` (a dict) receives each step's
    seconds (``seconds``), each check's (``val_seconds``) and each check's
    kernel launches (``val_launches``, ``ops.kernels.launch_counts``)."""
    import torch
    cfg = study_cfg("block", 0.5, iters, max(iters // 20, 1), precision="bf16")
    state, step = trainer(cfg, device, remat="selective")
    val_batches = [on_device(make_batch(1000 + j, size, size), device) for j in range(VAL_SCENES)]
    gen = torch.Generator()
    losses, val_series = [], []
    t0 = time.time()
    for i in range(iters):
        batch = on_device(make_batch(i % 64, size, size), device)
        ts = time.perf_counter()
        ld = step(state, batch, gen.manual_seed(STEP_SEED), **FLAGS)
        losses.append(float(ld["total"]))
        if record is not None:
            record.setdefault("seconds", []).append(time.perf_counter() - ts)
        if not np.isfinite(losses[-1]):
            print(f"NON-FINITE LOSS at iter {i}", flush=True)
            break
        if i % val_every == 0 or i == iters - 1:
            tv, before = time.perf_counter(), launch_counts()
            mad, mse = validate(state.model, val_batches)
            if record is not None:
                record.setdefault("val_seconds", []).append(time.perf_counter() - tv)
                record.setdefault("val_launches", []).append(
                    {k: v - before[k] for k, v in launch_counts().items()})
            val_series.append({"iter": i, "MADx1e3": mad, "MSEx1e3": mse, "loss": losses[-1]})
            print(f"iter {i}: loss {losses[-1]:.4f}, val MADx1e3 {mad:.2f}, "
                  f"MSEx1e3 {mse:.2f} ({time.time() - t0:.0f}s)", flush=True)
    return {"losses": losses, "val": val_series, "iters": iters, "size": size}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=2000)
    ap.add_argument("size", nargs="?", type=int, default=192)
    ap.add_argument("out", nargs="?", default="output/torch_port/train_long.json")
    ap.add_argument("val_every", nargs="?", type=int, default=200)
    ap.add_argument("--device", default=None, help="'cpu' for the plain twins; the card by default")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    res = run(args.iters, args.size, args.val_every, resolve_device(args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    losses, val = res["losses"], res["val"]
    print(f"done: mean loss first-50 {np.mean(losses[:50]):.4f} -> last-50 "
          f"{np.mean(losses[-50:]):.4f}; val MAD {val[0]['MADx1e3']:.2f} -> "
          f"{val[-1]['MADx1e3']:.2f}; all finite: {np.all(np.isfinite(losses))}")
    return res


if __name__ == "__main__":
    main()
