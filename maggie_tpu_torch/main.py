"""Command line of the port (port of ``tools/main.py``, eval only).

    python -m maggie_tpu_torch.main --config configs/maggie_image.yaml --eval-only
        [--precision 16|32] [--device cuda|cpu] [dotted.key value ...]

The run logs to ``<output_dir>/<name>/test-log_rank0.log``, starting with the
merged config as the JAX package's CLI dumps it, so ``tools/extract_results.py``
reads the log unchanged. The model runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import random

import numpy as np


def setup_logging(cfg) -> None:
    """Log to ``<output_dir>/test-log_rank0.log`` and stderr (one process)."""
    os.makedirs(cfg.output_dir, exist_ok=True)
    handlers = [logging.FileHandler(os.path.join(cfg.output_dir, "test-log_rank0.log")),
                logging.StreamHandler()]
    level = logging.DEBUG if os.environ.get("DEBUG") else logging.INFO
    logging.basicConfig(level=level, handlers=handlers,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s", force=True)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser("maggie_tpu_torch")
    parser.add_argument("--config", required=True)
    parser.add_argument("--precision", type=int, default=32, choices=[16, 32])
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="where the model runs (default: cuda; no fallback)")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = parser.parse_args(argv)
    if not args.eval_only:
        raise NotImplementedError("training is not ported yet: it is ROADMAP.md queue 1 "
                                  "item 10; pass --eval-only")

    from .config import load_config
    from .engine.test import test

    cfg = load_config(args.config, args.opts or [])
    if args.precision == 16:
        cfg.model.precision = "bf16"
    cfg.output_dir = os.path.join(cfg.output_dir, cfg.name)
    setup_logging(cfg)
    # the merged config heads the log (reference tools/main.py:38); the eval
    # sweep's results.csv extraction reads split and mask_dir_name from it
    logging.info("Config:\n" + cfg.dump())

    # seeding (reference tools/main.py:131-137): host-side python/numpy randomness
    seed = cfg.train.seed if cfg.train.seed >= 0 else 2023
    random.seed(seed)
    np.random.seed(seed)
    test(cfg, device=args.device)


if __name__ == "__main__":
    main()
