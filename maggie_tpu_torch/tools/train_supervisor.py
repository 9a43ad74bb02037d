"""Restart-on-failure around the port's trainer (port of ``tools/train_supervisor.py``).

  1. launch ``python -m maggie_tpu_torch.main --config ... [opts]`` as a child;
  2. on a non-zero exit, wait an exponential backoff, then relaunch with
     ``train.resume_last True`` appended if ``<output_dir>/<name>/last_state.pt``
     exists (a crash before the first checkpoint restarts fresh);
  3. stop on exit 0 (run finished), on ``--max-restarts`` exhausted, or after
     3 consecutive failures that checkpointed no new step (a crash loop: a
     bug rather than a transient fault).

Before each launch a killable child checks that the card is reachable
(``import torch; assert torch.cuda.is_available()``); while it is not, the
supervisor waits and probes again, counting neither a restart nor a
failure. With ``--device cpu`` among the forwarded arguments nothing is
probed. ``--device`` and ``--precision`` after ``--`` go to the trainer's
flags, everything else to its dotted config overrides. Pair with
``train.ckpt_iter N`` so the checkpoint cadence bounds lost work to N
iterations. A resumed trainer rebuilds its loader from the seed
(``data/loader.py``), so a supervised run equals the manual pair "a run that
fails, then ``train.resume_last True``", not an unbroken run.

Usage:
    python -m maggie_tpu_torch.tools.train_supervisor --config configs/maggie_image.yaml \\
        --max-restarts 20 -- [--device cpu] train.ckpt_iter 100 output_dir /tmp/run

Test hooks: ``MAGGIE_SUPERVISOR_MAIN`` (a script run in place of the
trainer, with the same arguments), ``MAGGIE_SUPERVISOR_PROBE`` (a shell
command whose exit status stands for the probe) and
``MAGGIE_SUPERVISOR_PROBE_INTERVAL`` (seconds between probes, default 60).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAINER_FLAGS = ("--device", "--precision")   # the trainer's flags that take a value


def _ckpt_step(output_dir: str) -> int:
    """The checkpointed step in ``output_dir``, -1 without a checkpoint
    (``engine/train.py`` writes ``last_step.txt`` beside ``last_state.pt``)."""
    if not os.path.isfile(os.path.join(output_dir, "last_state.pt")):
        return -1
    try:
        with open(os.path.join(output_dir, "last_step.txt")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0  # a checkpoint without its sidecar: resumable, step unknown


def _backend_alive(on_cpu: bool, env: dict, timeout_s: float = 120.0) -> bool:
    """True when the card is reachable, probed in a killable child (a card
    that has gone away can hang CUDA's initialisation); always True for a
    CPU run."""
    hook = os.environ.get("MAGGIE_SUPERVISOR_PROBE")
    try:
        if hook:
            return subprocess.call(hook, shell=True, timeout=timeout_s) == 0
        if on_cpu:
            return True
        return subprocess.call(
            [sys.executable, "-c", "import torch; assert torch.cuda.is_available()"],
            timeout=timeout_s, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env) == 0
    except subprocess.TimeoutExpired:
        return False


def split_forwarded(forwarded: list[str]) -> tuple[list[str], list[str]]:
    """The arguments after ``--``: (trainer flags with their values, config
    overrides)."""
    flags, opts = [], []
    it = iter(forwarded)
    for a in it:
        if a in TRAINER_FLAGS:
            value = next(it, None)
            if value is None:
                raise SystemExit(f"train_supervisor: {a} needs a value")
            flags += [a, value]
        else:
            opts.append(a)
    return flags, opts


def run(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--max-restarts", type=int, default=20)
    parser.add_argument("--backoff", type=float, default=5.0,
                        help="initial restart delay (s); doubles per consecutive "
                             "no-progress failure, capped at 300 s")
    parser.add_argument("--python", default=sys.executable)
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="the trainer's --device/--precision and dotted config overrides")
    args = parser.parse_args(argv)
    flags, opts = split_forwarded([o for o in args.opts if o != "--"])
    on_cpu = dict(zip(flags[::2], flags[1::2])).get("--device") == "cpu"

    main_py = os.environ.get("MAGGIE_SUPERVISOR_MAIN")
    trainer = [main_py] if main_py else ["-m", "maggie_tpu_torch.main"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # the effective run dir, as main.py resolves it: output_dir/name
    from ..config import load_config
    cfg = load_config(args.config, opts)
    output_dir = os.path.join(cfg.output_dir, cfg.name)

    restarts = 0
    no_progress_streak = 0
    delay = args.backoff
    while True:
        # A dead backend is an outage, not a crash loop: wait it out before
        # launching, without counting restarts or the no-progress streak.
        waited = 0.0
        interval = float(os.environ.get("MAGGIE_SUPERVISOR_PROBE_INTERVAL", 60))
        while True:
            t0 = time.perf_counter()
            alive = _backend_alive(on_cpu, env)
            probe_s = time.perf_counter() - t0
            if alive:
                break
            no_progress_streak = 0
            waited += interval
            print(f"[supervisor] backend unreachable (waited {waited:.0f}s); "
                  f"probing again in {interval:.0f}s", flush=True)
            time.sleep(interval)
        print(f"[supervisor] backend probe ok in {probe_s:.3f} s", flush=True)
        resume = ["train.resume_last", "True"] if _ckpt_step(output_dir) >= 0 else []
        cmd = [args.python, *trainer, "--config", args.config, *flags, *opts, *resume]
        step_before = _ckpt_step(output_dir)
        print(f"[supervisor] launch #{restarts}: {' '.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        rc = subprocess.call(cmd, env=env)
        child_s = time.perf_counter() - t0
        if rc == 0:
            print(f"[supervisor] training finished cleanly (child {child_s:.3f} s)", flush=True)
            return 0
        step_after = _ckpt_step(output_dir)
        progressed = step_after > step_before
        no_progress_streak = 0 if progressed else no_progress_streak + 1
        print(f"[supervisor] child exited rc={rc} after {child_s:.3f} s (ckpt step "
              f"{step_before} -> {step_after}, progress={progressed})", flush=True)
        if no_progress_streak >= 3:
            print("[supervisor] 3 consecutive failures with no checkpoint progress"
                  " — treating as a crash loop, giving up", flush=True)
            return rc
        restarts += 1
        if restarts > args.max_restarts:
            print(f"[supervisor] exceeded --max-restarts={args.max_restarts}", flush=True)
            return rc
        wait = min(delay * (2 ** no_progress_streak), 300.0) if not progressed else args.backoff
        print(f"[supervisor] restarting in {wait:.0f}s", flush=True)
        time.sleep(wait)


if __name__ == "__main__":
    sys.exit(run())
