"""Data parallelism of the port (``maggie_tpu_torch/parallel/``) on the CPU.

Two ranks are two processes (``tests/torch_ddp_worker.py``) in a gloo group,
spawned with ``subprocess`` on a free port, with a timeout on the group and
on ``communicate``, so that a hang fails the test and not the run. The
workers import torch and the port only; the single-process side of each
comparison runs the same worker code in this process without a group, and
every JAX computation happens here too. The model is
``tests/test_torch_train.py``'s (the flagship reduced to atten_dim 32 and
final_channel 32, the encoder at its published depth) on a global batch of 4
frames at 64x64 with 3 instances in 10 slots; rank r holds rows 2r, 2r + 1.

The contract (the JAX package's sharded step equals its single-device step,
``__graft_entry__.py:163-176``: total loss rtol 2e-4, params max |d| 1e-4):
a step at world size 2 computes what the single-process step computes on
the global batch. The sums of a world-2 step run in another order, and this
random-weight network amplifies f32 rounding through ~70 layers of batch
statistics of a few sites each (at 64x64 the encoder's os32 BatchNorms see
2x2 sites a frame): on one process alone, a 1e-7 relative change of the
input frames moves the gradients by 2.0e-3 (relative L2; 7.8e-3 on the
overflowing batch of (d)), and the first BatchNorm's E[x^2] - E[x]^2 turns
the two orders' 1-ulp sums into 1.8e-6 of its output. Readings on an x86
CPU with one torch thread a process (world 2 against one process, dropout
and random dilation on; (a), then (d) and (f)), and the limits set from
them:

- the total loss: 8.3e-8 (1.1e-7, 3.3e-7) -> TOTAL_RTOL 2e-5, the JAX
  check's 2e-4 tightened tenfold;
- each loss term (the ranks' parts summed), relative above an absolute
  1e-6 (the attention loss of a batch whose every slot is an instance is 0
  up to rounding): 2.5e-4 (2.5e-5, 3.6e-5) -> LOSS_RTOL 1e-3;
- gradients before the clip, relative L2 over all parameters and per
  tensor: 1.6e-3 and 1.3e-2 (1.1e-2 and 2.0e-2; 2.9e-3 and 7.5e-3) ->
  ``tests/test_torch_train.py``'s 5e-2 for both;
- parameters after one AdamW step: 9.7e-6 (1.19e-5, 1.12e-5) -> 2 lr + 1e-6
  = 1.3e-5 (the first update is about lr = 6e-6 whatever the gradient, so
  an element whose gradient sign flips moves by up to 2 lr), under the JAX
  check's 1e-4;
- BatchNorm running statistics: 8.8e-6 (1.4e-6, 1.2e-6) -> STATS_ATOL 5e-5;
  spectral u/v: 0 -> SN_ATOL 1e-6.
The two ranks hold equal parameters, statistics and u/v bit for bit, and
their step generators end in the single process's state. Module by module,
where nothing amplifies, BatchNorm and masked BatchNorm over two ranks hold
1e-5 of the concatenated batch (read 3.8e-6 at most).
"""

import itertools
import os
import re
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import torch_ddp_worker as worker
from test_torch_harness import (jax_shapes, jax_variables, one_torch_thread,  # noqa: F401
                                random_flat)
from maggie_tpu_torch import parallel
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.utils.convert_jax import convert_jax

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_ddp_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
TIMEOUT_S = 240
WORLD = 2
HW, N_INST, SLOTS, GLOBAL_BATCH = 64, 3, 10, 4
TOTAL_RTOL = 2e-5
LOSS_RTOL = 1e-3
LOSS_ATOL = 1e-6
GRAD_REL_L2 = 5e-2
GRAD_TENSOR_REL = 5e-2
PARAM_ATOL = 2 * 1.5e-4 / 25 + 1e-6      # 2 lr + 1e-6: a gradient sign flip
STATS_ATOL = 5e-5
SN_ATOL = 1e-6
FLAGS = dict(use_mask_atten=False, use_gt_guidance=False, use_prm_weights=True,
             atten_loss_enabled=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case: str, payload: dict, tmp_path, world: int = WORLD,
              local_world: int | None = None) -> list:
    """``case`` of the worker in ``world`` processes; their results by rank."""
    return start_ranks(case, payload, tmp_path, world, local_world)()


def start_ranks(case: str, payload: dict, tmp_path, world: int = WORLD,
                local_world: int | None = None, timeout: float = TIMEOUT_S):
    """Start ``case`` of the worker in ``world`` processes and return a
    function that waits for them (``timeout`` seconds) and returns their
    results by rank, so that the caller's own work runs meanwhile."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    in_path = tmp_path / f"{case}_in.pt"
    torch.save(payload, in_path)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(local_world or world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen([sys.executable, WORKER, case, str(in_path), str(tmp_path)],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    def wait() -> list:
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
        out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]
        for path in [in_path] + [tmp_path / f"rank{r}.pt" for r in range(world)]:
            path.unlink()     # the results (GBs for the step cases) live on in memory
        return out
    return wait


# ------------------------------------------------------------------ the model
def train_cfg(dropout: float):
    """``tests/test_torch_train.py``'s config with the FFN dropout ``dropout``."""
    from test_torch_train import train_cfg as jax_train_cfg
    cfg = jax_train_cfg()
    cfg.model.decoder_args.inst_spec_dropout = dropout
    return cfg


def global_batch(seed: int = 0, n: int = GLOBAL_BATCH, hw: int = HW, w: int | None = None) -> dict:
    """``n`` frames at ``hw`` x ``w`` (``hw`` x ``hw`` by default), ``N_INST``
    instances (uniform rectangles of alpha, half the frame's sides, so the GT
    masks supervise the attention) in ``SLOTS`` slots."""
    rs = np.random.RandomState(seed)
    h, w = hw, hw if w is None else w
    alpha = np.zeros((n, 1, SLOTS, h, w), np.float32)
    for b in range(n):
        for j in range(N_INST):
            y0, x0 = rs.randint(0, h // 2), rs.randint(0, w // 2)
            alpha[b, 0, j, y0:y0 + h // 2, x0:x0 + w // 2] = rs.rand(h // 2, w // 2)
    mask = np.zeros((n, 1, SLOTS, h // 8, w // 8), np.float32)
    mask[:, :, :N_INST] = rs.rand(n, 1, N_INST, h // 8, w // 8) > 0.5
    batch = {"image": rs.rand(n, 1, h, w, 3).astype(np.float32), "mask": mask,
             "alpha": alpha,
             "transition": ((rs.rand(*alpha.shape) > 0.8) & (alpha > 0)).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights():
    """The JAX model, its seeded variables and their port state_dict."""
    from maggie_tpu.models import build_model as jax_build_model
    jcfg = train_cfg(0.0)
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed=8)
    model = port_build_model(ConfigNode(jcfg.to_dict()).model, device="cpu")
    state = convert_jax(flat, model)
    return dict(jm=jm, variables=jax_variables(flat), state=state)


def step_payload(weights, dropout=0.1, modes=("none",), widths=None, batch=None, seed=5,
                 cfg=None, space=1):
    cfg = cfg if cfg is not None else train_cfg(dropout).to_dict()
    return dict(cfg=cfg, state=weights["state"], modes=list(modes), flags=FLAGS, seed=seed,
                widths=widths, batch=batch if batch is not None else global_batch(),
                space=space)


def summed_losses(ranks: list, mode: str = "none") -> dict:
    return {k: sum(r[mode]["losses"][k] for r in ranks) for k in ranks[0][mode]["losses"]}


def assert_ranks_equal(ranks: list, mode: str = "none") -> None:
    """Every rank holds the same model (parameters, statistics, u/v) bit for
    bit, the same gradient and the same generator state."""
    a = ranks[0][mode]
    for r in ranks[1:]:
        b = r[mode]
        assert a["digest"] == b["digest"]
        assert torch.equal(a["generator"], b["generator"])
        for k, g in a["grads"].items():
            assert torch.equal(g, b["grads"][k]), k


def compare_to_single(ranks: list, single: dict, mode: str = "none") -> dict:
    """World-2 ``ranks`` against one process's ``single`` step; returns the
    readings and asserts each limit."""
    got, want = ranks[0][mode], single[mode]
    losses = summed_losses(ranks, mode)
    total_rel = abs(losses["total"] - want["losses"]["total"]) / abs(want["losses"]["total"])
    loss_rel = max(abs(losses[k] - v) / max(abs(v), LOSS_ATOL / LOSS_RTOL)
                   for k, v in want["losses"].items())
    l2 = lambda t: float((t.double() ** 2).sum()) ** 0.5
    num = sum(l2(got["grads"][k] - g) ** 2 for k, g in want["grads"].items()) ** 0.5
    top = max(l2(g) for g in want["grads"].values())
    tensor_rel = max(l2(got["grads"][k] - g) / max(l2(g), 1e-6 * top)
                     for k, g in want["grads"].items())
    diff = lambda name: max((float((got[name][k] - v).abs().max()) for k, v in want[name].items()),
                            default=0.0)   # SparseMat has no spectral norm
    out = dict(total_rel=total_rel, loss_rel=loss_rel,
               grad_rel_l2=num / sum(l2(g) ** 2 for g in want["grads"].values()) ** 0.5,
               grad_tensor_rel=tensor_rel, params=diff("params"),
               batch_stats=diff("batch_stats"), spectral=diff("spectral"))
    print(out)
    assert set(losses) == set(want["losses"])
    assert out["total_rel"] <= TOTAL_RTOL, out
    assert out["loss_rel"] <= LOSS_RTOL, out
    assert out["grad_rel_l2"] <= GRAD_REL_L2, out
    assert out["grad_tensor_rel"] <= GRAD_TENSOR_REL, out
    assert out["params"] <= PARAM_ATOL, out
    assert out["batch_stats"] <= STATS_ATOL, out
    assert out["spectral"] <= SN_ATOL, out
    assert torch.equal(got["generator"], want["generator"])
    return out


def norms_payload() -> dict:
    """``BatchNorm`` and ``MaskedBatchNorm`` inputs on 4 rows; the masked
    layer with active sites in every row (``masked``), and with all of them
    in rows 0-1, so that rank 1 holds none (``masked_empty_rank``)."""
    rs = np.random.RandomState(3)
    c = 6
    x = torch.from_numpy((rs.randn(4, c, 9, 11) * 2 + 0.5).astype(np.float32))
    mask = torch.from_numpy((rs.rand(4, 1, 9, 11) > 0.4).astype(np.float32))
    stats = mask * torch.from_numpy((rs.rand(4, 1, 9, 11) > 0.3).astype(np.float32))
    empty = torch.cat([torch.ones(2, 1, 1, 1), torch.zeros(2, 1, 1, 1)])
    state = {"weight": torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32)),
             "bias": torch.from_numpy(rs.uniform(-.2, .2, c).astype(np.float32)),
             "running_mean": torch.from_numpy(rs.uniform(-.3, .3, c).astype(np.float32)),
             "running_var": torch.from_numpy(rs.uniform(.5, 1.5, c).astype(np.float32))}
    return dict(c=c, x=x, masks={"masked": (mask, stats),
                                 "masked_empty_rank": (mask * empty, stats * empty)},
                state=state, ct=torch.from_numpy(rs.randn(4, c, 9, 11).astype(np.float32)))


JAX_WIDTHS = [np.random.RandomState(k).randint(1, k, GLOBAL_BATCH * SLOTS) for k in (27, 15, 30, 15)]
# The row-sharded step's frames: 2 of 128 x 64, so that a space group of 2
# holds one 64-row block row a band and every block's halo crosses a band
# edge.
SPACE_BATCH, SPACE_HW = 2, (128, 64)


def space_batch(seed: int = 0) -> dict:
    return global_batch(seed, SPACE_BATCH, *SPACE_HW)


def space_overflow_cfg() -> dict:
    """The model at ``block_cap_frac`` 0.25: round(0.25 * 20 maps * 2
    blocks) = 10 entries for the up to 12 uncertain blocks of
    ``space_batch``'s 6 instance maps. (``full_batch``'s recipe, every slot
    an instance, is too ill-conditioned at 2 x 128 x 64 for the gradient
    limits: there a 1e-7 relative change of the input frames moves one
    process's own gradients by 3.9e-2 relative L2, 4.7e-2 per tensor;
    ``space_batch`` by 9.7e-3 and 1.8e-2.)"""
    cfg = train_cfg(0.1)
    cfg.model.decoder_args.block_cap_frac = 0.25
    return cfg.to_dict()


@pytest.fixture(scope="module")
def world2(weights, tmp_path_factory):
    """One spawn of two ranks runs every world-2 case of (a)-(f) in turn,
    while this process runs their single-process sides and JAX's step:
    {case: (ranks' results, this process's)}.

    - ``image``: the image step with dropout and random dilation on (widths
      and dropout drawn from the step generator), under each remat mode;
      one process on the global batch;
    - ``norms``: (c)'s layers (``norms_payload``);
    - ``jax``: dropout off and the four random-width dilations fed the same
      widths on both sides (``tests/test_torch_train.py``'s scheme, at the
      40 maps of the global batch; a rank takes its rows of each call's
      widths); JAX's single-device step on the global batch;
    - ``overflow``: a global batch that overflows the ladder's capacity;
      one process selecting per half as the ranks do, and one selecting
      the global top-cap blocks as the JAX package does;
    - ``video``: ``video_payload``;
    - row sharding at ``1 x 2`` (``parallel/space.py``: one data shard, each
      frame's rows over the two ranks): ``space_modules``, each banded piece
      of the step (``torch_ddp_worker._space_cases``) against one process
      on the whole tensors; ``space_image``, the step with dropout and
      random dilation on ``space_batch``; ``space_overflow``, that step at
      a capacity that overflows (``space_overflow_cfg``); each against one
      process; ``space_jax``,
      ``tests/test_torch_train.py``'s frame (128 x 128, its widths, dropout
      off) against JAX's single-device step. (On ``space_batch`` the port's
      one-process step itself reads 4.2e-5 and 4.6e-5 off JAX's in the os8
      L1 and gradient terms, over that file's 1e-5, as JAX's f32 sums
      amplify through the random network; on that file's frame it holds
      1e-5.)"""
    import jax.numpy as jnp
    import maggie_tpu.ops.morphology as jmorph
    import test_torch_train as ttrain

    jax_batch = global_batch(seed=1)
    space_jb, space_tb = ttrain.train_batch()
    payloads = {
        "image": ("step", step_payload(weights, modes=("none", "full", "selective"))),
        "norms": ("norms", norms_payload()),
        "jax": ("step", step_payload(weights, dropout=0.0, widths=JAX_WIDTHS, batch=jax_batch)),
        "overflow": ("step", step_payload(weights, batch=full_batch())),
        "video": ("step", video_payload()),
        "space_modules": ("space_modules", space_modules_payload()),
        "space_image": ("step", step_payload(weights, batch=space_batch(), space=WORLD)),
        "space_jax": ("step", step_payload(weights, dropout=0.0, widths=ttrain._WIDTHS,
                                           batch=space_tb, space=WORLD)),
        "space_overflow": ("step", step_payload(weights, batch=space_batch(), space=WORLD,
                                                cfg=space_overflow_cfg())),
    }
    wait = start_ranks("cases", {"cases": payloads}, tmp_path_factory.mktemp("ddp_world2"),
                       timeout=TIMEOUT_S * len(payloads))
    single = {"image": worker.run_step(dict(payloads["image"][1], modes=["none"])),
              "norms": worker.run_norms(payloads["norms"][1]),
              "overflow": (worker.run_step(dict(payloads["overflow"][1], split_select=WORLD)),
                           worker.run_step(payloads["overflow"][1])),
              "video": worker.run_step(payloads["video"][1]),
              "space_modules": worker.run_space_modules(payloads["space_modules"][1]),
              "space_image": worker.run_step(dict(payloads["space_image"][1], space=1)),
              "space_overflow": worker.run_step(dict(payloads["space_overflow"][1], space=1))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "_WIDTHS", JAX_WIDTHS)
        mp.setattr(jmorph, "dilate_ellipse_random",
                   ttrain._jax_dilate_with_widths(itertools.count()))
        single["jax"] = jax_step(weights, {k: jnp.asarray(v.numpy())
                                           for k, v in jax_batch.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random",
                   ttrain._jax_dilate_with_widths(itertools.count()))
        single["space_jax"] = train_file_jax_step(weights, space_jb)
    ranks = wait()
    return {name: ([r[name] for r in ranks], single[name]) for name in payloads}


@pytest.fixture(scope="module")
def image_steps(world2):
    """The image step with dropout and random dilation on: world 2 under
    each remat mode, and one process on the global batch."""
    return world2["image"]


def test_world2_image_step_equals_one_process(image_steps):
    """(a) Loss terms, gradients, parameters and AdamW moments after the
    update (through the parameters), BatchNorm statistics and SN u/v: world 2
    against one process on the global batch, dropout and dilation on."""
    ranks, single = image_steps
    assert_ranks_equal(ranks)
    readings = compare_to_single(ranks, single)
    print("world 2 vs one process:", readings)


@pytest.mark.parametrize("mode", ["full", "selective"])
def test_world2_remat_equals_world2_plain(image_steps, mode):
    """(e) ``model.remat`` full and selective at world 2, bit-equal to the
    plain world-2 step on every rank: the loss terms, the gradients, the
    model after the update and the generator."""
    ranks, _ = image_steps
    assert_ranks_equal(ranks, mode)
    for r in ranks:
        plain, remat = r["none"], r[mode]
        assert remat["losses"] == plain["losses"]
        assert remat["digest"] == plain["digest"]
        assert torch.equal(remat["generator"], plain["generator"])
        for k, g in plain["grads"].items():
            assert torch.equal(remat["grads"][k], g), k


NORM_ATOL = 1e-5


@pytest.fixture(scope="module")
def norms(world2):
    """``BatchNorm`` and ``MaskedBatchNorm`` on 2 ranks and in one process
    (``norms_payload``)."""
    return world2["norms"]


@pytest.mark.parametrize("name", ["bn", "masked", "masked_empty_rank"])
def test_batchnorm_over_ranks_equals_the_concatenated_batch(norms, name):
    """(c) Train-mode ``BatchNorm`` and ``MaskedBatchNorm`` over 2 ranks
    against one process on the concatenated rows: the output and the input
    gradient row by row, the weight and bias gradients summed over the
    ranks, and the running statistics (equal on both ranks), within 1e-5
    (f32 sums in another order; read 3.8e-6 at most, a bias gradient summed
    over 396 sites). In
    ``masked_empty_rank`` rank 1 holds no active site: its count of 0 joins
    the global count, and its rows' outputs and gradients are 0."""
    ranks, single = norms
    want = single[name]
    got = [r[name] for r in ranks]
    for k in ("y", "x_grad"):
        np.testing.assert_allclose(torch.cat([g[k] for g in got]).numpy(), want[k].numpy(),
                                   rtol=0, atol=NORM_ATOL, err_msg=k)
    for k in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(sum(g[k] for g in got).numpy(), want[k].numpy(),
                                   rtol=0, atol=NORM_ATOL, err_msg=k)
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[0][k].numpy(), want[k].numpy(), rtol=0, atol=NORM_ATOL,
                                   err_msg=k)
    if name == "masked_empty_rank":
        assert float(got[1]["y"].abs().max()) == 0.0
        assert float(want["x_grad"][2:].abs().max()) == 0.0
    print(name, {k: float((torch.cat([g[k] for g in got]) - want[k]).abs().max())
                 for k in ("y", "x_grad")},
          {k: float((sum(g[k] for g in got) - want[k]).abs().max())
           for k in ("weight_grad", "bias_grad")},
          {k: float((got[0][k] - want[k]).abs().max()) for k in ("running_mean", "running_var")})


# ------------------------------------------------------- against JAX's step
def jax_step(weights, jbatch):
    """JAX ``make_train_step`` (``maggie_tpu/engine/train_step.py:82-103``) on
    one device: the forward, loss and gradients jitted, then the optax update
    (jitted apart) and the new state, so that one compile also gives the
    gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from maggie_tpu.engine.train_step import TrainState as JaxTrainState

    jm, v = weights["jm"], weights["variables"]
    tx, _ = jax_build_optimizer(train_cfg(0.0))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          opt_state=jax.jit(tx.init)(v["params"]), batch_stats=v["batch_stats"],
                          spectral=v["spectral"])

    @jax.jit
    def grads(state, batch, rng):
        k_unknown, k_dropout = jax.random.split(jax.random.fold_in(rng, state.step))

        def loss_fn(params):
            (_, ld), mutated = jm.apply(
                {"params": params, "batch_stats": state.batch_stats, "spectral": state.spectral},
                batch, train=True, update_sn=True, **FLAGS,
                rngs={"unknown": k_unknown, "dropout": k_dropout},
                mutable=["batch_stats", "spectral"])
            return ld["total"], (ld, mutated)
        (_, (ld, mutated)), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return ld, g, mutated
    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state
    ld, g, mutated = grads(state, jbatch, jax.random.PRNGKey(1))
    params, opt_state = update(g, state.opt_state, state.params)
    new = state.replace(step=state.step + 1, params=params, opt_state=opt_state,
                        batch_stats=mutated["batch_stats"], spectral=mutated["spectral"])
    return ld, g, new


def train_file_jax_step(weights, jb):
    """``tests/test_torch_train.py``'s JAX step (``make_train_step`` with the
    gradients kept, default flags, its widths) from ``weights`` on ``jb``:
    (state after, loss dict), compiled once with that file's when it holds
    the port to the same step (``test_torch_train.jax_image_step``)."""
    import jax
    import test_torch_train as ttrain
    from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from maggie_tpu.engine.train_step import TrainState as JaxTrainState
    from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step

    v = weights["variables"]
    tx = ttrain._keeping_grads(jax_build_optimizer(train_cfg(0.0))[0])
    jstate = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=v["params"],
                           opt_state=jax.jit(tx.init)(v["params"]), batch_stats=v["batch_stats"],
                           spectral=v["spectral"])
    return ttrain.jax_image_step(jstate, jb, jax_make_train_step(weights["jm"], tx))


@pytest.fixture(scope="module")
def jax_vs_world2(world2):
    """The world-2 port step and JAX's single-device step on the global batch,
    dropout off and the four random-width dilations fed the same widths on
    both sides."""
    ranks, (jld, jgrads, jstate) = world2["jax"]
    return ranks, jld, jgrads, jstate


def test_world2_image_step_matches_jax(jax_vs_world2):
    """(b) The world-2 step against JAX's single-device step on the global
    batch, at ``tests/test_torch_train.py``'s limits: the loss terms (the
    ranks' parts summed), the gradients before the clip, and the state
    after one update."""
    from test_torch_train import _check_grads, _check_losses, _check_state, _flat
    from maggie_tpu_torch.utils.convert_jax import to_jax

    ranks, jld, jgrads, jstate = jax_vs_world2
    assert_ranks_equal(ranks)
    got = ranks[0]["none"]
    _check_losses(jld, summed_losses(ranks))
    _check_grads(_flat("params", jgrads), to_jax(got["grads"]))
    tstate = types.SimpleNamespace(params=lambda: got["params"],
                                   batch_stats=lambda: got["batch_stats"],
                                   spectral=lambda: got["spectral"])
    _check_state(jstate, tstate, lr=got["lr"])


# ------------------------------------------------- the ladder's capacity rule
def full_batch(seed: int = 2) -> dict:
    """The global batch with every one of the 10 slots an instance: 40 maps
    with uncertain blocks against a capacity of round(0.5 * 40 * 1) = 20."""
    rs = np.random.RandomState(seed)
    b = global_batch(seed)
    alpha = rs.rand(GLOBAL_BATCH, 1, SLOTS, HW, HW).astype(np.float32)
    mask = (rs.rand(GLOBAL_BATCH, 1, SLOTS, HW // 8, HW // 8) > 0.3).astype(np.float32)
    b.update(alpha=torch.from_numpy(alpha), mask=torch.from_numpy(mask),
             transition=torch.from_numpy((rs.rand(*alpha.shape) > 0.8).astype(np.float32)))
    return b


@pytest.fixture(scope="module")
def overflow_steps(world2):
    """A global batch that overflows the ladder's capacity: world 2 (each
    rank selects its own blocks at its own capacity), one process selecting
    per half as the ranks do, and one process selecting the global top-cap
    blocks as the JAX package does."""
    ranks, (per_half, top_cap) = world2["overflow"]
    return ranks, per_half, top_cap


def test_capacity_rule_per_rank(image_steps, overflow_steps):
    """(d) The ladder selects blocks per rank, at the rank's own capacity
    round(0.5 * N_rank * blocks) (ROADMAP "Known differences, by design"),
    where the JAX package selects the global batch's top blocks at the
    global capacity. Without overflow (``image_steps``' batch) both keep
    every active block, and the world-2 step equals one process
    (``test_world2_image_step_equals_one_process``). With overflow, the
    world-2 step equals one process that selects per half (within (a)'s
    limits) and differs from the global top-cap selection: its gap (kept
    blocks, loss) is printed and asserted to be there."""
    ranks, _ = image_steps
    for r in ranks:
        for sel in r["none"]["selections"]:
            assert sel["active"] == sel["kept"] <= sel["cap"], sel
    ranks, per_half, top_cap = overflow_steps
    world_sel = [r["none"]["selections"][0] for r in ranks]
    half_sel, top_sel = per_half["none"]["selections"][0], top_cap["none"]["selections"][0]
    assert all(s["active"] > s["cap"] and s["kept"] == s["cap"] for s in world_sel)
    assert sum(s["cap"] for s in world_sel) == top_sel["cap"] == half_sel["cap"]
    assert sorted(sum((s["blocks"] for s in world_sel), [])) == half_sel["blocks"]
    compare_to_single(ranks, per_half)
    gap_blocks = len(set(map(tuple, half_sel["blocks"])) ^ set(map(tuple, top_sel["blocks"])))
    losses = summed_losses(ranks)
    gap = {k: abs(losses[k] - v) / abs(v) for k, v in top_cap["none"]["losses"].items()}
    print(f"per-rank vs global top-cap selection: {gap_blocks} of {2 * top_sel['cap']} kept "
          f"blocks differ; loss terms' relative gap: {gap}")
    assert gap_blocks > 0 and gap["total"] > TOTAL_RTOL


# ------------------------------------------------------------ the video step
def video_payload() -> dict:
    """``tests/test_torch_video_train.py``'s reduced video model (3 slots,
    ``bi_fusion``) with dropout 0.1 and random dilation on, one step on two
    clips of 3 frames at 64x64 (a 2-frame clip's dtSSD is 0/0), a clip a
    rank. The ladder has room for every block (``block_cap_frac`` 1): at
    0.5 a rank's 9 maps of one block each get round(4.5) = 4 entries where
    the global 18 get 9, and 6 of them are active, so both sides would
    overflow (test (d) covers that rule)."""
    from test_torch_video_train import clip_batch, train_video_cfg
    from maggie_tpu_torch.utils.convert_jax import to_jax
    cfg = train_video_cfg()
    cfg.model.decoder_args.inst_spec_dropout = 0.1
    cfg.model.decoder_args.block_cap_frac = 1.0
    model = port_build_model(ConfigNode(cfg.to_dict()).model, device="cpu")
    shapes = {k: v.shape for k, v in to_jax(model.state_dict()).items()}
    state = convert_jax(random_flat(dict(sorted(shapes.items())), seed=10), model)
    clips = [clip_batch(seed)[1] for seed in (0, 1)]
    batch = {k: torch.cat([c[k] for c in clips]) for k in clips[0]}
    return step_payload({"state": state}, batch=batch, cfg=cfg.to_dict())


@pytest.fixture(scope="module")
def video_steps(world2):
    """The video step: world 2 (a clip a rank) and one process."""
    return world2["video"]


def test_world2_video_step_equals_one_process(video_steps):
    """(f) The video step at clip 3, world 2 against one process on the two
    clips, at (a)'s limits; the temporal losses included."""
    ranks, single = video_steps
    assert_ranks_equal(ranks)
    assert "loss_temp" in single["none"]["losses"]
    for sel in [s for r in ranks for s in r["none"]["selections"]]:
        assert 0 < sel["active"] == sel["kept"] <= sel["cap"], sel
    print("video world 2 vs one process:", compare_to_single(ranks, single))


# ------------------------------------------- row sharding at 1 x 2 (space.py)
SPACE_ATOL = 1e-5       # relative to each tensor's largest magnitude


def space_modules_payload() -> dict:
    """``torch_ddp_worker._space_cases``' inputs: two (4, 128, 128) maps (a
    band of 64 rows a rank), their os4 and os8 sizes, a 0/1 mask, and 6
    distinct os4 blocks of 16 (halo 4) over the 2 x 2 block grid of each
    map, so that half of them sit in each band and every window crosses a
    band edge or the frame's."""
    rs = np.random.RandomState(4)
    h = w = 128
    cells = np.array([(n, y, x) for n in range(2) for y in range(2) for x in range(2)])
    cells = cells[rs.permutation(len(cells))[:6]]
    f = lambda *shape: torch.from_numpy(rs.randn(*shape).astype(np.float32))
    return dict(x=f(2, 4, h, w), x4=f(2, 4, h // 4, w // 4), x8=f(2, 4, h // 8, w // 8),
                mask=torch.from_numpy((rs.rand(2, 1, h, w) > 0.5).astype(np.float32)),
                blocks=[torch.from_numpy(cells[:, i].copy()) for i in range(3)])


@pytest.fixture(scope="module")
def space_modules(world2):
    return world2["space_modules"]


def _close(got: torch.Tensor, want: torch.Tensor, what: str, exact: bool = False) -> float:
    diff = float((got - want).abs().max()) if want.numel() else 0.0
    scale = max(float(want.abs().max()) if want.numel() else 0.0, 1.0)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert diff == 0.0 if exact else diff <= SPACE_ATOL * scale, (what, diff, scale)
    return diff


def test_space_exchanges_are_exact(space_modules):
    """``space.halo_rows`` and ``space.gather_rows`` on a band of two rows
    ranks against the whole tensor, bit for bit: the halo'd bands are the
    whole map's rows with zeros beyond the frame, the gathered frame is the
    whole map on both ranks. Backward: each element's gradient is the sum
    of the cotangents of every rank's output that holds it (a halo row
    twice, a gathered frame on both ranks: the reduce-scatter)."""
    ranks, single = space_modules
    x = space_modules_payload()["x"]
    h = x.shape[-2] // WORLD
    ct = lambda y, row0: worker._cotangent(y, y.dim() - 2, row0)
    want_grad = torch.zeros_like(x)
    for r, got in enumerate(r["halo_rows"] for r in ranks):
        lo = r * h
        padded = torch.nn.functional.pad(x, (0, 0, 3, 2))
        assert torch.equal(got["y"][0], padded[..., lo:lo + h + 5, :])
        g = torch.nn.functional.pad(torch.zeros_like(x), (0, 0, 3, 2))
        g[..., lo:lo + h + 5, :] = ct(got["y"][0], lo - 3)
        want_grad += g[..., 3:-2, :]
    got_grad = torch.cat([r["halo_rows"]["x_grad"] for r in ranks], -2)
    _close(got_grad, want_grad, "halo_rows grad")
    assert torch.equal(single["halo_rows"]["y"][0], torch.nn.functional.pad(x, (0, 0, 3, 2)))
    for r in ranks:
        assert torch.equal(r["gather_rows"]["y"][0], x)
    got_grad = torch.cat([r["gather_rows"]["x_grad"] for r in ranks], -2)
    assert torch.equal(got_grad, ct(x, 0) * WORLD)


SPACE_MODULES = ["conv", "conv_stride2", "sn_conv", "batchnorm", "masked_batchnorm",
                 "resize_os4_halo", "resize_os8_whole", "sobel", "laplacian", "active_pyramid",
                 "unknown", "gather_scatter"]


@pytest.mark.parametrize("name", SPACE_MODULES)
def test_space_banded_module_equals_one_process(space_modules, name):
    """Each banded piece of the row-sharded step on two ranks' bands
    against one process on the whole tensors (the same code without a
    group): convs (stride 1 and 2, spectral norm's power step), BatchNorm
    and masked BatchNorm over both bands, the os4 band's resize with a
    halo row and the whole os8 map's band rows, the Sobel (replicate) and
    Laplacian (reflect, 3 levels of ``[::2]``) filters, the active-set
    pyramid, K2's plain twin and the random-width dilation (``rows_op``),
    and K1's twin on band-plus-halo maps with its cores scattered into the
    band. Outputs (the bands concatenated, K1's entries by band) and the
    input's gradient (bands concatenated; the whole os8 map's summed over
    the ranks): discrete ones exact, floats within 1e-5 of each tensor's
    scale (read: up to 7.6e-6 absolute on resize gradients of O(10))."""
    ranks, single = space_modules
    got, want = [r[name] for r in ranks], single[name]
    by = space_modules_payload()["blocks"][1]
    exact = name in ("active_pyramid", "unknown")
    for i, w in enumerate(want["y"]):
        ys = [g["y"][i] for g in got]
        if name == "gather_scatter" and i == 0:
            cat = torch.empty_like(w)
            for r, y in enumerate(ys):
                cat[(by >= r) & (by < r + 1)] = y
        else:
            cat = torch.cat(ys, 1 if name == "gather_scatter" else -2)
        _close(cat, w, f"{name} output {i}", exact or name == "gather_scatter")
    if want["x_grad"] is not None:
        grads = [g["x_grad"] for g in got]
        total = sum(grads) if name == "resize_os8_whole" else torch.cat(grads, -2)
        _close(total, want["x_grad"], f"{name} input gradient")


@pytest.fixture(scope="module")
def space_steps(world2):
    return {k: world2[k] for k in ("space_image", "space_jax", "space_overflow")}


def _space_selections_equal(ranks: list, single: dict) -> None:
    """Every space rank records its data shard's whole selection: the one
    process's, block for block."""
    for r in ranks:
        assert r["none"]["selections"] == single["none"]["selections"]


def test_space_step_equals_one_process(space_steps):
    """The flagship step (reduced widths) row-sharded at ``1 x 2`` on two
    frames of 128 x 64, dropout and random dilation on, against one
    process on the whole frames at (a)'s limits: equal block selections,
    both ranks bit-equal, the generators in the one process's state."""
    ranks, single = space_steps["space_image"]
    assert_ranks_equal(ranks)
    _space_selections_equal(ranks, single)
    sel = single["none"]["selections"][0]
    assert 0 < sel["active"] == sel["kept"] <= sel["cap"], sel
    print("space 1 x 2 vs one process:", compare_to_single(ranks, single))


def test_space_step_matches_jax(space_steps):
    """The row-sharded step at ``1 x 2`` against JAX's single-device step on
    ``tests/test_torch_train.py``'s frame (128 x 128, 3 instances; dropout
    off, the dilations' widths fed alike), at that file's limits: the
    contract the JAX package's own sharded step meets
    (``tests/test_multidevice.py:106-115``)."""
    from test_torch_train import _check_grads, _check_losses, _check_state, _flat
    from maggie_tpu_torch.utils.convert_jax import to_jax

    ranks, (jstate, jld) = space_steps["space_jax"]
    assert_ranks_equal(ranks)
    got = ranks[0]["none"]
    _check_losses(jld, summed_losses(ranks))
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(got["grads"]))
    tstate = types.SimpleNamespace(params=lambda: got["params"],
                                   batch_stats=lambda: got["batch_stats"],
                                   spectral=lambda: got["spectral"])
    _check_state(jstate, tstate, lr=got["lr"])


def test_space_overflow_equals_one_process(space_steps):
    """The ladder over its capacity (``space_overflow_cfg``) row-sharded at
    ``1 x 2``: one data shard selects its whole frames' top blocks, as one
    process does, so the step equals one process at (a)'s limits with the
    same kept blocks, the dropped ones' neighbours reading zeros from the
    dense hand-offs alike."""
    ranks, single = space_steps["space_overflow"]
    assert_ranks_equal(ranks)
    _space_selections_equal(ranks, single)
    sel = single["none"]["selections"][0]
    assert sel["active"] > sel["cap"] == sel["kept"], sel
    print("space 1 x 2 overflow vs one process:", compare_to_single(ranks, single))


def test_ranks_that_disagree_on_the_flags_raise(weights, tmp_path):
    """The step checks, before its forward, that every rank runs the same
    remat mode and flags (the trainer draws them from the same host
    ``RandomState`` on every rank): here rank 1 alone guides by the GT, and
    both ranks raise."""
    errors = run_ranks("disagree", step_payload(weights), tmp_path)
    assert all("the ranks disagree on the train step's remat mode and flags" in e
               for e in errors), errors


# ------------------------------------------------------ the CLI on two ranks
CKPT = {"last_state.pt", "best_model.npz", "best_score.txt", "last_step.txt",
        "best_metrics.txt", "train_meters.json", "config.yaml"}


def cli_opts(root, out_dir, *extra):
    """``tests/test_torch_train_engine.py``'s options (4 train frames, 2 val
    frames, 64x64 crops, batch 2 a host) with validation sharded."""
    from test_torch_train_engine import _opts
    return _opts(root, out_dir, "train.val_dist", "True", *extra)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``main.main`` on 2 gloo ranks (torchrun's variables set, one process
    each): 3 iterations validating at 2 and saving at 3, then a resume to
    5; and ``--eval-only`` on the same ranks against one process."""
    from test_torch_train_engine import CONFIG, him_root
    root = him_root.__wrapped__(tmp_path_factory)
    out = tmp_path_factory.mktemp("ddp_cli")
    base = ["--config", CONFIG, "--device", "cpu"]
    fresh = base + cli_opts(root, out, "train.max_iter", "3", "train.val_iter", "2",
                            "train.ckpt_iter", "3")
    resume = base + cli_opts(root, out, "train.max_iter", "5", "train.val_iter", "1000",
                             "train.ckpt_iter", "5", "train.resume_last", "True")
    evaluate = base + ["--eval-only"] + cli_opts(root, out, "name", "eval", "model.weights",
                                                 str(out / "run" / "best_model.npz"))
    runs = [(fresh, free_port()), (resume, free_port()), (evaluate, free_port())]
    ranks = run_ranks("cli", {"runs": runs}, out / "ranks")
    from maggie_tpu_torch.main import main
    single = main(evaluate + ["name", "eval_single"])
    return dict(ranks=ranks, single=single, run=out / "run")


def test_cli_on_two_ranks_writes_from_rank0_only(cli_runs):
    """(g) Rank 0 writes the config, the checkpoints and the sidecars; rank
    1 writes its own log and nothing else; both log the same global losses
    at every iteration."""
    ranks, run = cli_runs["ranks"], cli_runs["run"]
    for i in (0, 1):   # the train runs
        assert ranks[1][i]["writes"] == ["log_rank1.log"], ranks[1][i]["writes"]
        assert "log_rank0.log" in ranks[0][i]["writes"]
    assert CKPT - {"best_model.npz", "best_metrics.txt"} <= set(ranks[0][1]["writes"])
    assert CKPT <= set(ranks[0][0]["writes"])
    for name in CKPT | {"log_rank0.log", "log_rank1.log"}:
        assert (run / name).is_file(), name
    logs = [re.findall(r"Iter: (\d+)/\d+, .*?total: ([-\w.]+)",
                       (run / f"log_rank{r}.log").read_text()) for r in (0, 1)]
    assert logs[0] == logs[1] and [int(i) for i, _ in logs[0]] == [1, 2, 3, 4, 5]
    assert "Validation:MAD" in (run / "log_rank0.log").read_text()


def test_cli_ranks_hold_equal_parameters_and_resume(cli_runs):
    """(g) Both ranks hold the same model after every update, bit for bit;
    the resume starts at the saved step 3 on both and reaches step 5."""
    ranks = cli_runs["ranks"]
    for i, steps in ((0, [0, 1, 2]), (1, [3, 4])):
        assert ranks[0][i]["steps"] == ranks[1][i]["steps"] == steps
        assert ranks[0][i]["digests"] == ranks[1][i]["digests"]
        assert len(set(ranks[0][i]["digests"])) == len(steps)
    assert ranks[0][0]["result"] == ranks[1][0]["result"] == 3
    assert ranks[0][1]["result"] == ranks[1][1]["result"] == 5
    assert (cli_runs["run"] / "last_step.txt").read_text() == "5"


def test_sharded_test_equals_one_process(cli_runs):
    """(h) ``--eval-only`` (``engine/test.py::test``) over 2 ranks, each
    scoring one of the 2 val frames: rank 0 reports the metrics of one
    process over both, rank 1 none, and only rank 0 writes
    ``results.csv``. Within rtol 1e-6: one process keeps some metrics' sums
    in float32, the gather adds the ranks' in float64 (read 3.1e-8)."""
    ranks, single = cli_runs["ranks"], cli_runs["single"]
    got = ranks[0][2]["result"]
    assert ranks[1][2]["result"] == {} and set(got) == set(single) and len(got) > 3
    for k, v in single.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
    assert "results.csv" in ranks[0][2]["writes"]
    assert ranks[1][2]["writes"] == ["test-log_rank1.log"]


# ------------------------------------------------------- in this process
def test_batch_must_split_over_the_hosts_ranks(monkeypatch, tmp_path):
    """(i) ``train.batch_size`` is one host's batch: 3 over 2 ranks raises a
    ``ValueError`` naming both, before any data or model is built."""
    from test_torch_train_engine import CONFIG
    from maggie_tpu_torch import main as cli
    with pytest.raises(ValueError, match="batch_size 3 .* its 2 ranks"):
        parallel.rank_batch_size(3, 2)
    assert parallel.rank_batch_size(4, 2) == 2 and parallel.rank_batch_size(3, 1) == 3
    monkeypatch.setattr(parallel, "local_world", lambda: 2)
    built = []
    monkeypatch.setattr("maggie_tpu_torch.engine.train.build_dataset",
                        lambda *a, **kw: built.append(1))
    with pytest.raises(ValueError, match="batch_size 3 .* its 2 ranks"):
        cli.main(["--config", CONFIG, "--device", "cpu", "output_dir", str(tmp_path),
                  "train.batch_size", "3"])
    assert built == []


def _torchrun_env(monkeypatch, world=1, rank=0):
    for k, v in dict(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank, LOCAL_WORLD_SIZE=world,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port()).items():
        monkeypatch.setenv(k, str(v))


def test_world1_group_is_bit_equal_to_no_group(weights, monkeypatch):
    """(j) A gloo group of one rank joined through ``init_from_env``: the
    step (dropout and dilation on) equals the step without a group bit for
    bit: loss terms, gradients, the model after the update, the generator."""
    import torch.distributed as dist
    p = step_payload(weights)
    alone = worker.run_step(p)["none"]
    _torchrun_env(monkeypatch)
    assert parallel.init_from_env(device="cpu") == torch.device("cpu")
    try:
        assert dist.is_initialized() and parallel.world() == 1 and parallel.rank() == 0
        grouped = worker.run_step(p)["none"]
    finally:
        parallel.destroy()
    assert not dist.is_initialized()
    assert grouped["losses"] == alone["losses"] and grouped["digest"] == alone["digest"]
    assert torch.equal(grouped["generator"], alone["generator"])
    for k, g in alone["grads"].items():
        assert torch.equal(grouped["grads"][k], g), k


def test_init_from_env_needs_the_card_unless_asked(monkeypatch):
    """No fallback: without torchrun's variables, and on a host without a
    card when the caller does not ask for the CPU, ``init_from_env``
    raises and joins no group."""
    import torch.distributed as dist
    for k in parallel.dist.ENV:
        monkeypatch.delenv(k, raising=False)
    assert not parallel.launched()
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_from_env(device="cpu")
    _torchrun_env(monkeypatch)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.init_from_env()
    assert not dist.is_initialized()


def test_helpers_are_the_identity_without_a_group():
    """Without a group every helper returns its input's own value: the
    single-process code path."""
    x = torch.arange(6.0).reshape(3, 2)
    assert parallel.world() == 1 and parallel.rank() == 0 and parallel.local_world() == 1
    assert parallel.all_reduce_sum(x) is x and parallel.global_sum(x) is x
    assert parallel.global_max(x) is x and torch.equal(parallel.global_mean(x), x.mean())
    g = torch.Generator().manual_seed(0)
    want = torch.rand((3, 2), generator=torch.Generator().manual_seed(0))
    assert torch.equal(parallel.shard_draw(lambda s: torch.rand(s, generator=g), (3, 2)), want)
    d = {"a": torch.tensor(1.5)}
    assert parallel.sum_values(d) is d
    parallel.check_same("nothing", 1)
    parallel.barrier()
    rows = parallel.shard_rows({"x": torch.arange(8)}, 1, 4)
    assert rows["x"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="do not split"):
        parallel.shard_rows({"x": torch.arange(7)}, 0, 2)
