"""One rank of the data-parallel tests of the port (``tests/test_torch_ddp.py``).

    RANK=r WORLD_SIZE=w LOCAL_RANK=r LOCAL_WORLD_SIZE=w MASTER_ADDR=127.0.0.1 \\
        MASTER_PORT=p python tests/torch_ddp_worker.py CASE IN.pt OUT_DIR

joins a gloo group through ``parallel.init_from_env(device="cpu")``, runs
``CASE`` on what ``IN.pt`` holds (written by the test with ``torch.save``), and
writes its result to ``OUT_DIR/rank{r}.pt``. It imports torch and the port
only. The test also imports this module and runs ``run_step`` and
``run_norms`` in its own process without a group: the single-process side
of each comparison is the same code at world size 1.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import torch

from maggie_tpu_torch import parallel
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.parallel import space


def _cpu(d: dict) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in d.items()}


def digest(model) -> str:
    """A hash of every parameter and buffer's bytes."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def injected_widths(widths: list):
    """``dilate_ellipse_random`` with the global batch's widths of each call
    in turn (one array per call, over every map of the global batch),
    of which a rank takes its rows, as ``parallel.shard_draw`` takes a draw's."""
    import maggie_tpu_torch.ops.morphology as tmorph
    orig = tmorph.dilate_ellipse_random
    calls = iter(range(1 << 30))

    def dilate(binary, k_size, generator=None):
        full = torch.from_numpy(np.asarray(widths[next(calls) % len(widths)]))
        n = int(np.prod(binary.shape[:-2]))

        def draw(shape):
            assert shape == tuple(full.shape), (shape, tuple(full.shape))
            return full
        return orig(binary, k_size, widths=parallel.shard_draw(draw, (n,)))
    return dilate


def recorded_selection(record: list, split: int = 1):
    """The ladder's ``select_blocks`` recording each call's capacity, active
    blocks (positive score), kept blocks and the kept blocks' (map, by, bx)
    in the global batch's map numbering. With ``split`` > 1 (one process),
    each of ``split`` contiguous parts of the maps selects its own blocks
    at its share of the capacity, as that many ranks would."""
    import maggie_tpu_torch.models.decoder_sparse as ds
    select = ds.select_blocks

    def recording(mask, block, cap):
        n = mask.shape[0] // split
        if split == 1:
            idx_n, by, bx, valid = select(mask, block, cap)
        else:
            assert cap % split == 0, (cap, split)
            parts = [select(mask[i * n:(i + 1) * n], block, cap // split) for i in range(split)]
            idx_n = torch.cat([q[0] + i * n for i, q in enumerate(parts)])
            by, bx, valid = (torch.cat([q[j] for q in parts]) for j in (1, 2, 3))
        h, w = mask.shape[1] // block, mask.shape[2] // block
        scores = mask[:, :h * block, :w * block].reshape(-1, h, block, w, block).sum((2, 4))
        offset = parallel.data_rank() * mask.shape[0]
        record.append({"cap": cap, "active": int((scores > 0).sum()), "kept": int(valid.sum()),
                       "blocks": sorted((int(a) + offset, int(b), int(c)) for a, b, c, v
                                        in zip(idx_n, by, bx, valid) if v)})
        return idx_n, by, bx, valid
    return recording


def emptied_active_set(rows: list):
    """``SparseMat.dilate`` with the active set of the global batch's
    ``rows`` emptied (a rank takes its rows' part), so that a rank may hold
    no active site in any masked BatchNorm."""
    from maggie_tpu_torch.models.sparsemat import SparseMat
    orig = SparseMat.dilate

    def dilate(self, alpha):
        out = orig(self, alpha)
        first = parallel.rank() * out.shape[0]
        keep = torch.ones(out.shape[0], 1, 1, 1, dtype=out.dtype, device=out.device)
        for r in rows:
            if first <= r < first + out.shape[0]:
                keep[r - first] = 0
        return out * keep
    return dilate


def run_step(p: dict) -> dict:
    """One ``make_train_step`` step from ``p['state']`` on this rank's rows of
    ``p['batch']`` for each remat mode of ``p['modes']``, the step generator
    seeded from ``p['seed']``: this rank's loss terms, the gradients as the
    clip receives them (summed over the ranks), the parameters, BatchNorm
    statistics and spectral u/v after, the whole state dict after, the
    generator's state after, a hash of the model, and the ladder's block
    selections (``recorded_selection``, ``p['split_select']`` parts).
    ``p['empty_rows']``: rows of the global batch whose SparseMat active set
    is emptied (``emptied_active_set``). ``p['space']`` > 1 splits the world
    into ``data x space`` ranks (``space.init_groups``) for the step, each
    rank on its band of its data shard's frames (``space.shard_batch_2d``);
    the selections are then the shard's whole frame's, as every space rank
    of it selects."""
    from maggie_tpu_torch.models import build_model

    cfg = ConfigNode(p["cfg"])
    model = build_model(cfg.model, device="cpu")
    n_space = p.get("space", 1)
    if n_space > 1:
        space.init_groups(n_space)
        batch = space.shard_batch_2d(p["batch"], parallel.rank(), parallel.world(), n_space)
    else:
        batch = parallel.shard_rows(p["batch"], parallel.rank(), parallel.world())
    try:
        return _steps(p, cfg, model, batch)
    finally:
        space.init_groups(1)


def _steps(p: dict, cfg, model, batch) -> dict:
    import maggie_tpu_torch.models.decoder_sparse as ds
    import maggie_tpu_torch.ops.morphology as tmorph
    from maggie_tpu_torch.engine import train_step as ts
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.models.sparsemat import SparseMat

    out = {}
    for mode in p["modes"]:
        model.load_state_dict(p["state"])
        model.train()
        opt, schedule = build_optimizer(cfg, model.parameters())
        state = ts.TrainState(model, opt)
        step = ts.make_train_step(model, opt, schedule, remat=mode)
        grads, clip, dilate = [], ts.clip_by_global_norm_, tmorph.dilate_ellipse_random
        select, selections = ds.select_blocks, []
        ds.select_blocks = recorded_selection(selections, p.get("split_select") or 1)

        def keep(gs, *a, **kw):
            grads.extend(g.detach().clone() for g in gs)
            return clip(gs, *a, **kw)
        ts.clip_by_global_norm_ = keep
        if p.get("widths") is not None:
            tmorph.dilate_ellipse_random = injected_widths(p["widths"])
        sm_dilate = SparseMat.dilate
        if p.get("empty_rows"):
            SparseMat.dilate = emptied_active_set(p["empty_rows"])
        gen = torch.Generator().manual_seed(p["seed"])
        try:
            losses = step(state, batch, gen, **p["flags"])
        finally:
            ts.clip_by_global_norm_, tmorph.dilate_ellipse_random = clip, dilate
            ds.select_blocks, SparseMat.dilate = select, sm_dilate
        out[mode] = {"losses": {k: float(v) for k, v in losses.items()}, "lr": schedule(0),
                     "grads": dict(zip((k for k, _ in model.named_parameters()), grads)),
                     "params": _cpu(state.params()), "batch_stats": _cpu(state.batch_stats()),
                     "spectral": _cpu(state.spectral()), "generator": gen.get_state(),
                     "state_dict": {k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()},
                     "digest": digest(model), "selections": selections}
    return out


def run_atten(p: dict) -> dict:
    """TCVOM's attention loss (``TCVOM.compute_atten_loss``) on this rank's
    rows of ``p``'s GT alphas, logits ``attb``/``attf`` and bands (one per
    middle frame), and its backward: this rank's part of the loss and the
    gradients of its rows' logits."""
    from maggie_tpu_torch.models.tcvom import TCVOM

    r, w = parallel.rank(), parallel.world()
    rows = lambda t: None if t is None else parallel.shard_rows({"t": t}, r, w)["t"]
    attb = [None if t is None else rows(t).clone().requires_grad_() for t in p["attb"]]
    attf = [None if t is None else rows(t).clone().requires_grad_() for t in p["attf"]]
    loss = TCVOM.compute_atten_loss(rows(p["alphas"]), attb, attf,
                                    [rows(m) for m in p["small_mask"]])
    loss.backward()
    return {"loss": loss.detach(), "band_count": [None if m is None else float(rows(m).sum())
                                                  for m in p["small_mask"]],
            "attb_grad": [None if t is None else t.grad for t in attb],
            "attf_grad": [None if t is None else t.grad for t in attf]}


def run_cases(p: dict) -> dict:
    """Each case of ``p['cases']`` (name -> (worker case, payload)) in turn,
    in one group: the results by name."""
    return {name: CASES[case](payload) for name, (case, payload) in p["cases"].items()}


def run_disagree(p: dict) -> str:
    """The train step with ``use_gt_guidance`` true on rank 1 only: the error
    it raises on this rank (before any forward), or "" if it ran."""
    from maggie_tpu_torch.engine import train_step as ts
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.models import build_model

    cfg = ConfigNode(p["cfg"])
    model = build_model(cfg.model, device="cpu").train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    step = ts.make_train_step(model, opt, schedule)
    batch = parallel.shard_rows(p["batch"], parallel.rank(), parallel.world())
    flags = dict(p["flags"], use_gt_guidance=parallel.rank() == 1)
    try:
        step(ts.TrainState(model, opt), batch, torch.Generator(), **flags)
    except RuntimeError as exc:
        return str(exc)
    return ""


def run_norms(p: dict) -> dict:
    """A train-mode ``BatchNorm``, and a ``MaskedBatchNorm`` for each (mask,
    statistics mask) of ``p['masks']``, forward and backward on this rank's
    rows of ``p``'s inputs and cotangents: the outputs, the
    input gradients, the weight and bias gradients (this rank's parts; their
    sum over the ranks is the global batch's) and the running statistics."""
    from maggie_tpu_torch.models.layers import BatchNorm
    from maggie_tpu_torch.models.sparse_layers import MaskedBatchNorm

    r, w = parallel.rank(), parallel.world()
    rows = lambda t: parallel.shard_rows({"t": t}, r, w)["t"]
    out = {}
    cases = [("bn", BatchNorm(p["c"]), ())] + [
        (name, MaskedBatchNorm(p["c"]), (rows(mask), rows(stats)))
        for name, (mask, stats) in p["masks"].items()]
    for name, mod, args in cases:
        mod.load_state_dict(p["state"], strict=False)
        mod.train()
        x = rows(p["x"]).clone().requires_grad_()
        y = mod(x, *args)
        (y * rows(p["ct"])).sum().backward()
        out[name] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": mod.weight.grad,
                     "bias_grad": mod.bias.grad, "running_mean": mod.running_mean.clone(),
                     "running_var": mod.running_var.clone()}
    return out


def run_cli(p: dict) -> dict:
    """``main.main(argv)`` for each ``(argv, port)`` of ``p['runs']`` in turn,
    each joining its own group on ``port``: the names of the files this rank
    opened for writing (an audit hook sees every ``open``, ``numpy.savez``'s
    too; ``torch.save`` is wrapped), the model's hash after each update, the step
    each update started at, and the result (the final step, or the eval
    metrics)."""
    import maggie_tpu_torch.engine.train as tr
    from maggie_tpu_torch import main as cli

    writes: list = []
    sys.addaudithook(lambda event, args: _record_write(event, args, writes))
    save = torch.save

    def recorded_save(obj, f, *a, **kw):   # its writer opens the file in C++
        writes.append(os.path.basename(os.fsdecode(f)))
        return save(obj, f, *a, **kw)
    torch.save = recorded_save
    out = []
    for argv, port in p["runs"]:
        os.environ["MASTER_PORT"] = str(port)
        digests, steps = [], []
        make = tr.make_train_step

        def recorded_make(model, optimizer, schedule, remat="none"):
            step = make(model, optimizer, schedule, remat)

            def call(state, *a, **kw):
                steps.append(state.step)
                loss = step(state, *a, **kw)
                digests.append(digest(model))
                return loss
            return call
        tr.make_train_step = recorded_make
        writes.clear()
        try:
            result = cli.main(argv)
        finally:
            tr.make_train_step = make
        out.append({"writes": sorted(set(writes)), "digests": digests, "steps": steps,
                    "result": result.step if hasattr(result, "step") else result})
    return out


def _record_write(event: str, args, writes: list) -> None:
    if event != "open" or not isinstance(args[0], (str, bytes, os.PathLike)):
        return
    mode, flags = args[1], args[2]
    if (mode is not None and any(c in mode for c in "wax+")) or (
            mode is None and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
        writes.append(os.path.basename(os.fsdecode(args[0])))


def _space_cases(p: dict) -> dict:
    """name -> (fn, input key, input kind, output kinds) of
    ``run_space_modules``. ``fn`` maps the input (this rank's band of
    ``p[key]`` for kind "band", the whole tensor for "whole") to a tuple of
    outputs, each the band's rows (dim -2, or dim 1 for "band1") of the
    whole frame's, the entries of blocks in the band ("entries"), or
    discrete ("band0": the band's rows, no gradient)."""
    from maggie_tpu_torch.models.layers import BatchNorm, Conv2d, SNConv
    from maggie_tpu_torch.models.losses import laplacian_pyramid, sobel_magnitude
    from maggie_tpu_torch.models.sparse_layers import MaskedBatchNorm, active_pyramid
    from maggie_tpu_torch.ops.blocksparse import gather_patches_rows, scatter_blocks
    from maggie_tpu_torch.ops.kernels.unknown import compute_unknown
    from maggie_tpu_torch.ops.morphology import compute_unknown_random

    def module(m):
        m.init_params(torch.Generator().manual_seed(7))
        return m.train()
    conv, conv_s2 = module(Conv2d(4, 5, 3, padding=1)), module(Conv2d(4, 5, 3, 2, 1))
    sn_conv, bn = module(SNConv(4, 5, 3, 1, 1)), module(BatchNorm(4))
    mbn = module(MaskedBatchNorm(4))
    h = p["x"].shape[-2]
    mask = _band(p["mask"], -2)
    idx_n, by, bx = (t.contiguous() for t in p["blocks"])
    keep = _keep(by, 16, h // 4)
    by0 = space.band(h // 64)[0]        # os4 blocks of 16 rows are os1 blocks of 64

    def k1(x4):
        ent = [t[keep] for t in (idx_n, by, bx)]
        patches = gather_patches_rows(x4.permute(0, 2, 3, 1), *ent, 16, 4, by0)
        band = scatter_blocks(patches[:, 4:20, 4:20], ent[0], ent[1] - by0, ent[2],
                              torch.ones_like(ent[0], dtype=torch.bool),
                              (x4.shape[0], x4.shape[2], x4.shape[3], x4.shape[1]), fill=-1.0)
        return patches, band

    def resize_halo(x4):
        return (space.resize_rows(x4, (x4.shape[-2] * 4, x4.shape[-1] * 4), halo=1),)

    def resize_whole(x8):
        return (space.resize_rows(x8, (h // space.world(), x8.shape[-1] * 8)),)

    def unknown(x):
        a = torch.sigmoid(x.detach() * 3)
        k2 = space.rows_op(a, 15, lambda t: compute_unknown(t, 30))
        return k2, compute_unknown_random(a, 27, torch.Generator().manual_seed(2))

    return {
        "halo_rows": (lambda x: (space.halo_rows(x, 3, 2),), "x", "band", ("halo",)),
        "gather_rows": (lambda x: (space.gather_rows(x),), "x", "band", ("whole",)),
        "conv": (lambda x: (conv(x),), "x", "band", ("band",)),
        "conv_stride2": (lambda x: (conv_s2(x),), "x", "band", ("band",)),
        "sn_conv": (lambda x: (sn_conv(x),), "x", "band", ("band",)),
        "batchnorm": (lambda x: (bn(x),), "x", "band", ("band",)),
        "masked_batchnorm": (lambda x: (mbn(x, mask),), "x", "band", ("band",)),
        "resize_os4_halo": (resize_halo, "x4", "band", ("band",)),
        "resize_os8_whole": (resize_whole, "x8", "whole", ("band",)),
        "sobel": (lambda x: (sobel_magnitude(x),), "x", "band", ("band",)),
        "laplacian": (lambda x: tuple(laplacian_pyramid(x[:, :1])), "x", "band",
                      ("band",) * 3),
        "active_pyramid": (lambda x: active_pyramid((x[:, :1] > 0.5).float())[1:], "x", "band",
                           ("band0",) * 3),
        "unknown": (unknown, "x", "band", ("band0", "band0")),
        "gather_scatter": (k1, "x4", "band", ("entries", "band1")),
    }


def _band(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's band of ``t``'s rows along ``dim`` (all of it alone)."""
    lo, hi = space.band(t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


def _keep(by: torch.Tensor, block: int, rows: int) -> torch.Tensor:
    """The entries whose core (block row ``by``) lies in this rank's band of
    ``rows`` rows."""
    lo, hi = space.band(rows // block)
    return (by >= lo) & (by < hi)


def _cotangent(y: torch.Tensor, dim: int, row0: int, entries=None) -> torch.Tensor:
    """A fixed cotangent for ``y`` whose every element is a function of its
    place in the whole frame's output: row ``row0 + i`` along ``dim``, entry
    ``entries[e]`` along dim 0 where given."""
    arg = torch.zeros((), dtype=torch.float64)
    for k, (n, f) in enumerate(zip(y.shape, (0.37, 1.3, 0.11, 0.07, 0.05))):
        t = torch.arange(n, dtype=torch.float64)
        if k == dim:
            t = t + row0
        if k == 0 and entries is not None:
            t = entries.double()
        arg = arg + (t * f).reshape([-1 if i == k else 1 for i in range(y.dim())])
    return torch.sin(arg).float()


def run_space_modules(p: dict) -> dict:
    """Each banded piece of the row-sharded step (``_space_cases``) on this
    rank's band of ``p``'s inputs, with a space group of the whole world
    (alone, the same code on the whole tensors): the outputs, and the
    input's gradient for cotangents that are the band's part of the whole
    frame's (``_cotangent``)."""
    space.init_groups(parallel.world())
    try:
        out = {}
        for name, (fn, key, kind, out_kinds) in _space_cases(p).items():
            x = p[key] if kind == "whole" else _band(p[key], -2)
            x = x.clone().requires_grad_()
            ys = fn(x)
            loss = 0.0
            for y, k in zip(ys, out_kinds):
                if not y.requires_grad:
                    continue
                r = space.rank()
                if k == "entries":
                    keep = _keep(p["blocks"][1], 16, p["x"].shape[-2] // 4)
                    ct = _cotangent(y, 0, 0, keep.nonzero()[:, 0])
                elif k == "band1":
                    ct = _cotangent(y, 1, r * y.shape[1])
                elif k == "halo":
                    ct = _cotangent(y, y.dim() - 2, r * x.shape[-2] - 3)
                else:
                    ct = _cotangent(y, y.dim() - 2, 0 if k == "whole" else r * y.shape[-2])
                loss = loss + (y * ct).sum()
            if torch.is_tensor(loss):
                loss.backward()
            out[name] = {"y": [y.detach() for y in ys], "x_grad": x.grad}
    finally:
        space.init_groups(1)
    return out


CASES = {"step": run_step, "norms": run_norms, "cli": run_cli, "disagree": run_disagree,
         "atten": run_atten, "cases": run_cases, "space_modules": run_space_modules}


def main(case: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    payload = torch.load(in_path, weights_only=False)
    rank = int(os.environ["RANK"])
    if case == "cli":   # the CLI joins (and leaves) the group itself
        result = run_cli(payload)
    else:
        parallel.init_from_env(device="cpu")
        try:
            result = CASES[case](payload)
        finally:
            parallel.destroy()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:4])
