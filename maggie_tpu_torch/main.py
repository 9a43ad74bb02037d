"""Command line of the port (port of ``tools/main.py``).

    python -m maggie_tpu_torch.main --config configs/maggie_image.yaml
        [--eval-only] [--precision 16|32] [--device cuda|cpu] [--sweep-job]
        [dotted.key value ...]

Without ``--eval-only`` it trains (``engine/train.py``), logging to
``<output_dir>/<name>/log_rank0.log`` and writing the merged config to
``config.yaml`` beside it; with it, it evaluates, logging to
``test-log_rank0.log``. Each log starts with the merged config, as the JAX
package's CLI writes it, so ``tools/extract_results.py`` reads an eval log
unchanged; an eval also writes ``results.csv`` beside it (split, masks and
every metric of the run, video metrics included). The model runs on the card
unless ``--device cpu``; asking for the card on a host without one raises
before anything is written.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np


def setup_logging(cfg, eval_only: bool) -> None:
    """Log to ``<output_dir>/{test-log,log}_rank0.log`` and stderr (one process)."""
    os.makedirs(cfg.output_dir, exist_ok=True)
    prefix = "test-log" if eval_only else "log"
    handlers = [logging.FileHandler(os.path.join(cfg.output_dir, f"{prefix}_rank0.log")),
                logging.StreamHandler()]
    level = logging.DEBUG if os.environ.get("DEBUG") else logging.INFO
    logging.basicConfig(level=level, handlers=handlers,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s", force=True)


def write_results_csv(cfg, results: dict) -> str:
    """``<output_dir>/results.csv``: one row of the eval's metrics under the
    split and the mask set, named as ``tools/extract_results.py`` names them."""
    path = os.path.join(cfg.output_dir, "results.csv")
    masks = str(cfg.dataset.test.get("mask_dir_name", "")).replace("masks_matched_", "")
    with open(path, "w") as f:
        f.write("split,masks," + ",".join(results) + "\n")
        f.write(",".join([str(cfg.dataset.test.split), masks]
                         + [str(v) for v in results.values()]) + "\n")
    return path


def main(argv: list[str] | None = None):
    """Run the CLI; returns the final train state when it trains, else the
    eval metrics."""
    parser = argparse.ArgumentParser("maggie_tpu_torch")
    parser.add_argument("--config", required=True)
    parser.add_argument("--precision", type=int, default=32, choices=[16, 32])
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="where the model runs (default: cuda; no fallback)")
    parser.add_argument("--sweep-job", action="store_true",
                        help="wandb sweep job: the agent already called wandb.init")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)

    from .config import load_config
    from .device import resolve_device

    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.opts or [])
    if args.precision == 16:
        cfg.model.precision = "bf16"
    cfg.output_dir = os.path.join(cfg.output_dir, cfg.name)
    setup_logging(cfg, args.eval_only)
    # the merged config heads the log (reference tools/main.py:38); the eval
    # sweep's results.csv extraction reads split and mask_dir_name from it
    logging.info("Config:\n" + cfg.dump())

    # seeding (reference tools/main.py:131-137): host-side python/numpy randomness
    seed = cfg.train.seed if cfg.train.seed >= 0 else 2023
    random.seed(seed)
    np.random.seed(seed)
    if args.eval_only:
        from .engine.test import test
        results = test(cfg, device=dev)
        if results:
            logging.info(f"Wrote {write_results_csv(cfg, results)}")
        return results
    with open(os.path.join(cfg.output_dir, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    from .engine.train import train
    return train(cfg, device=dev, is_sweep=args.sweep_job)


if __name__ == "__main__":
    main()
