"""Train ``configs/maggie_video.yaml`` on N cards of one host under ``torchrun``
and report what the yaml's global batch costs.

    python3 ddp_video_trainer.py [N] [ITERS]

Builds the port's CUDA kernels, writes ``chip_smoke.py`` phase 9.3's synthetic
V-HIM train split (2 videos of 16 frames at 720x1280, 3 moving instances) and
its VIM val video into a temp dir, and runs ``python -m torch.distributed.run
--standalone --nproc_per_node N -m maggie_tpu_torch.main --config
configs/maggie_video.yaml`` with ``train.batch_size N`` (one host's batch: one
clip of 8 frames a card, the yaml's 4 x 8 on 4 cards) in f32 at full width for
ITERS iterations (default 12), logging every iteration and not validating.
Prints each card's name and power limit, then one JSON line: the ranks' logged
losses (finite, equal on every rank), ms per iteration and ``data_time`` (the
loop's meters, first iteration left out), clips/s and each rank's peak memory
(from its log). Exits non-zero where it has fewer than N cards or a check
fails; details go to output/torch_port/ddp_video_trainer.json.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

OUT = os.path.join("output", "torch_port", "ddp_video_trainer.json")


def rank_log(path: str) -> dict:
    """{iteration: (total loss, peak MB or None)} of one rank's train log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.search(r"Iter: (\d+)/\d+, .*?total: ([-\w.]+)", line)
            if m:
                peak = re.search(r"max_mem: (\d+)MB", line)
                out[int(m[1])] = (float(m[2]), peak and float(peak[1]))
    return out


def main(n: int = 4, iters: int = 12) -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        cs.fail(f"needs {n} CUDA devices; this host has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for card in cards[:n]:
        print(f"card: {card}", flush=True)
    from maggie_tpu_torch.ops.kernels import build
    build.build_all()
    with tempfile.TemporaryDirectory() as root:
        cs.video_train_set(root)
        cs.video_set(root, cs.VIDEO_TRAINER_VAL_SET)
        out_dir = os.path.join(root, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               str(n), "-m", "maggie_tpu_torch.main", "--config", cs.VIDEO_CONFIG,
               "name", "ddp", "output_dir", out_dir, "dataset.train.root_dir", root,
               "dataset.train.split", "V", "dataset.test.root_dir", root,
               "dataset.test.split", "chip", "train.batch_size", str(n),
               "train.max_iter", str(iters), "train.val_iter", str(10 * iters),
               "train.log_iter", "1"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
        run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=1800)
        if run.returncode != 0:
            cs.fail(f"torchrun exited {run.returncode}:\n{(run.stdout + run.stderr)[-4000:]}")
        logs = [rank_log(os.path.join(out_dir, "ddp", f"log_rank{r}.log")) for r in range(n)]
        with open(os.path.join(out_dir, "ddp", "train_meters.json")) as f:
            meters = json.load(f)
    want = list(range(1, iters + 1))
    if any(sorted(log) != want for log in logs):
        cs.fail(f"the ranks logged iterations {[sorted(log) for log in logs]}, not {want}")
    totals = [[log[i][0] for i in want] for log in logs]
    if any(t != totals[0] for t in totals) or not np.all(np.isfinite(totals[0])):
        cs.fail(f"the ranks' logged losses differ or are not finite: {totals}")
    result = {"cards": cards[:n], "ranks": n, "global_batch": meters["batch_size"],
              "clip": 8, "iterations": iters,
              "ms_per_iteration": 1e3 * meters["batch_time_avg_s"],
              "data_time_ms": 1e3 * meters["data_time_avg_s"],
              "clips_per_s": meters["samples_per_sec_sustained"],
              "peak_mb_per_rank": [log[iters][1] for log in logs],
              "logged_total": totals[0]}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({**result, "meters": meters}, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:3])))
