"""The port's entry points for a quick check of a build (counterpart of
``__graft_entry__.py``).

``entry()`` returns the flagship image model's eval forward and its example
arguments; ``dryrun_multichip(n)`` runs one real flagship train step over
``n`` ranks and raises unless it equals one process on the whole batch:

    python -m maggie_tpu_torch.dryrun N [--device cpu] [--full]

The ranks copy the JAX entry's mesh: ``data n/2 x space 2`` for even n >= 4
(each frame's rows split over a space group, ``parallel/space.py``), else
``data n``. Reduced dims (atten_dim 32, final_channel 32) by default; with
``--full`` the flagship's (128, 64) at 256x256, as the JAX entry's
``MAGGIE_DRYRUN_FULL``. One frame a data rank, 2 instances in 10 slots, at
128x128 where space is 2 (a band is whole 64-row ladder blocks; the JAX
entry runs 64x64) and 64x64 otherwise. The ranks run on the card unless
``device="cpu"``: one card a rank with NCCL where the host has ``n``
cards, else every rank on ``cuda:0`` with gloo; gloo on the CPU. The
limits are the JAX entry's (``__graft_entry__.py:166-180``): total loss
rtol 2e-4, parameters after the step within 1e-4; the ranks must hold
bit-equal parameters.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

TIMEOUT_S = 900
STEP_FLAGS = dict(use_mask_atten=False, use_gt_guidance=True, use_prm_weights=True,
                  atten_loss_enabled=True)
LOSS_RTOL = 2e-4
PARAM_ATOL = 1e-4


def image_model_cfg(atten_dim: int = 128, final_channel: int = 64):
    """The flagship (``flagship.flagship_cfg``) at the given attention and
    final widths, with the JAX dryrun's optimizer (AdamW 1.5e-4, cosine over
    100 iterations after 10 of warmup)."""
    from .flagship import flagship_cfg
    cfg = flagship_cfg()
    cfg.model.decoder_args.update(dict(atten_dim=atten_dim, final_channel=final_channel,
                                       warmup_mask_atten_iter=0, warmup_detail_iter=3000,
                                       detail_mask_dropout=0.1))
    cfg.train.optimizer.update(dict(name="adamw", lr=1.5e-4))
    cfg.train.scheduler.update(dict(name="cosine", warmup_iters=10))
    cfg.train.max_iter = 100
    return cfg


def make_batch(b: int, n_f: int, n_i: int, h: int, w: int, with_gt: bool = False,
               seed: int = 0) -> dict:
    """``__graft_entry__._make_batch``'s numpy recipe as CPU tensors."""
    import torch
    rs = np.random.RandomState(seed)
    batch = {"image": rs.rand(b, n_f, h, w, 3).astype(np.float32),
             "mask": (rs.rand(b, n_f, n_i, h // 8, w // 8) > 0.6).astype(np.float32)}
    if with_gt:
        batch["alpha"] = rs.rand(b, n_f, n_i, h, w).astype(np.float32)
        batch["transition"] = (rs.rand(b, n_f, n_i, h, w) > 0.7).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(cfg, device, seed: int = 0):
    import torch
    from .models import build_model
    from .models.layers import init_weights
    model = build_model(cfg.model, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def entry():
    """(fn, example_args): the flagship image model's eval forward
    ``fn(model, batch) -> refined_masks`` and ``(model, batch)``, one frame
    of 256x256 with 2 instances, on the card."""
    from .device import resolve_device
    dev = resolve_device(None)
    model = _model(image_model_cfg(), dev).eval()
    batch = {k: v.to(dev) for k, v in make_batch(1, 1, 2, 256, 256).items()}

    def fn(model, batch):
        return model(batch)["refined_masks"]

    return fn, (model, batch)


def mesh(n: int) -> tuple[int, int]:
    """(data, space) ranks of ``n``: the JAX entry's choice."""
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def run_step(cfg, state: dict, batch: dict, device, seed: int = 1) -> dict:
    """One ``make_train_step`` step of the model ``cfg`` builds, from
    ``state``, on ``batch`` (this rank's part, or the whole batch on one
    process): its loss terms, the gradients the optimizer applies, and the
    parameters, statistics, spectral u/v and step generator after, on the
    CPU, with a hash of the model."""
    import hashlib

    import torch
    from .engine.optim import build_optimizer
    from .engine.train_step import TrainState, make_train_step
    from .models import build_model

    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(state)
    model = model.to(device).train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    names = {id(p): k for k, p in model.named_parameters()}
    grads = {}
    opt.register_step_pre_hook(lambda o, a, kw: grads.update(
        {names[id(p)]: p.grad.detach().float().cpu().clone() for p in model.parameters()}))
    step = make_train_step(model, opt, schedule)
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = {k: v.to(device) for k, v in batch.items()}
    state_ = TrainState(model, opt)
    losses = step(state_, batch, gen, **STEP_FLAGS)
    cpu = lambda d: {k: v.detach().float().cpu().clone() for k, v in d.items()}
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return {"losses": {k: float(v) for k, v in losses.items()}, "lr": schedule(0),
            "grads": grads, "params": cpu(state_.params()),
            "batch_stats": cpu(state_.batch_stats()), "spectral": cpu(state_.spectral()),
            "generator": gen.get_state().cpu(), "digest": h.hexdigest(), "step": state_.step}


def _rank_main(work: str) -> None:
    """One rank of ``dryrun_multichip``, started with torchrun's variables."""
    import torch
    from . import parallel
    from .parallel import space

    p = torch.load(os.path.join(work, "in.pt"), weights_only=False)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if p["device"] == "cpu":
        torch.set_num_threads(1)
        dev = parallel.init_from_env(device="cpu")
    elif p["per_card"]:
        dev = parallel.init_from_env()
    else:   # ranks that share a card: gloo (NCCL refuses two ranks on one device)
        dev = parallel.init_from_env(device="cuda:0", backend="gloo")
    try:
        data, n_space = mesh(world)
        space.init_groups(n_space)
        if n_space > 1:
            batch = space.shard_batch_2d(p["batch"], rank, world, n_space)
        else:
            batch = parallel.shard_rows(p["batch"], rank, world)
        record = run_step(p["cfg"], p["state"], batch, dev)
        record["mesh"] = (data, n_space)
        if dev.type == "cuda":
            record["peak_mb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
        torch.save(record, os.path.join(work, f"rank{rank}.pt"))
    finally:
        parallel.destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n: int, device: str = "cuda", full: bool = False) -> dict:
    """One real flagship train step over ``n`` ranks (``mesh(n)``), held
    against one process on the whole batch; raises unless it equals it.
    Returns ``{"ranks": [record, ...], "single": record, "mesh": (data,
    space), "hw": side}`` (``run_step``'s records)."""
    import torch
    from .config import ConfigNode
    from .device import resolve_device

    dev = resolve_device(device)
    data, n_space = mesh(n)
    cfg = image_model_cfg() if full else image_model_cfg(atten_dim=32, final_channel=32)
    cfg = ConfigNode(cfg.to_dict())
    hw = 256 if full else (128 if n_space > 1 else 64)
    batch = make_batch(data, 1, 2, hw, hw, with_gt=True)
    state = _model(cfg, "cpu").state_dict()
    per_card = dev.type == "cuda" and torch.cuda.device_count() >= n
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory(prefix="maggie_dryrun_") as work:
        torch.save({"cfg": cfg, "state": state, "batch": batch, "device": dev.type,
                    "per_card": per_card}, os.path.join(work, "in.pt"))
        port, procs = _free_port(), []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
            if dev.type == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "maggie_tpu_torch.dryrun", "--rank-worker", work],
                env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            single = run_step(cfg, state, batch, dev)
            logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip({n}) rank {r} exited {p.returncode}:\n"
                                   f"{log[-4000:]}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                 for r in range(n)]
    total = sum(r["losses"]["total"] for r in ranks)
    total1 = single["losses"]["total"]
    if not np.isfinite(total) or abs(total - total1) > LOSS_RTOL * abs(total1):
        raise RuntimeError(f"dryrun_multichip({n}): sharded loss {total} != one process's "
                           f"{total1} (rtol {LOSS_RTOL})")
    if any(r["digest"] != ranks[0]["digest"] or r["step"] != 1 for r in ranks):
        raise RuntimeError(f"dryrun_multichip({n}): the ranks hold different models after "
                           f"the step")
    pdiff = max(float((ranks[0]["params"][k] - v).abs().max())
                for k, v in single["params"].items())
    if not pdiff < PARAM_ATOL:
        raise RuntimeError(f"dryrun_multichip({n}): post-step parameters differ from one "
                           f"process's by {pdiff} (limit {PARAM_ATOL})")
    kind = f"data {data} x space {n_space}" if n_space > 1 else f"data {data}"
    dims = "full flagship dims" if full else "reduced dims"
    print(f"dryrun_multichip({n}) OK [{kind}, {dims}, {hw}x{hw}, {dev.type}]: loss={total:.4f} "
          f"(one process {total1:.4f}, max param diff {pdiff:.2e})")
    return {"ranks": ranks, "single": single, "mesh": (data, n_space), "hw": hw}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true", help="the flagship's full dims at 256x256")
    ap.add_argument("--rank-worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        _rank_main(args.rank_worker)
    elif args.n is None:
        ap.error("the number of ranks is required")
    else:
        dryrun_multichip(args.n, device=args.device, full=args.full)


if __name__ == "__main__":
    main()
