"""Rematerialisation of the baselines' train steps (``model.remat`` ``full`` and
``selective``) on the CPU: ``configs/mgm_stacked.yaml`` (the MaGGIe harness
with the dense decoder), ``configs/mgm_tcvom.yaml`` (``TCVOM_SingInst``),
``configs/sparsemat_image.yaml`` (``SparseMat_SingInst``) and the dense
InstMatt decoder (``res_shortcut_inst_matt_22`` on the harness), at the
sizes, weights and batches of their families' train-step tests
(``test_torch_mgm.py``, ``test_torch_tcvom.py``: two clips of 4, so that
two FAM passes chain each decoder spectral norm's power steps in one
segment; ``test_torch_sparsemat.py``; ``test_torch_inst_dense.py``: two
frames; ``mgm_tcvom``'s and the dense decoder's batches are
``tests/test_torch_baseline_ddp.py``'s global ones).

For each config and mode:

- (a) the remat step against the port's plain step, the random-width
  dilations of the fusion drawn from the step generator: every loss term,
  every gradient before the clip, the parameters after AdamW, the
  BatchNorm (and masked BatchNorm, ``IBNorm``) statistics with
  ``num_batches_tracked``, the spectral-norm u/v and the generator's state
  afterwards are bit-equal;
- (b) the remat step against the JAX package's ``make_train_step`` on the
  same weights, the fusion's widths fed the same on both sides (by the
  dilation's size, so that a recompute gets them again), at the tolerances
  of the family's train-step test (its helper). JAX's remat modes differ
  from its plain step only in what they keep for the backward, and the
  port's remat steps are bit-equal to its plain one by (a), so one plain
  JAX step a config (``JAX_MODE``, compiled once for the module) serves
  both modes; it is the step the family's own train-step test compiles
  (the same weights, batch, widths and optimizer), which the persistent
  compile cache shares between the two files;
- (c) under ``selective``, the segments that ``remat.Stages`` runs: 3 for
  the harness (encoder, ASPP, the rest), 2 for TCVOM (encoder, the rest),
  1 for SparseMat (all of it, as ``full``); the tensors that the segments
  before the last hand on are the ones the JAX package tags
  ``checkpoint_name(x, "stage")`` (recorded from the trace of its train
  forward in (b)'s JAX step), and the last segment ends in the losses.

And the CLI: ``main --config configs/mgm_stacked.yaml --device cpu
model.remat selective`` leaves the parameters and buffers the plain run
leaves, bit for bit.
"""

import contextlib
import copy
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.ad_checkpoint
import jax.numpy as jnp
import torch

import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.engine.train_step as ts
import maggie_tpu_torch.models.decoder_inst_dense as tdense
import maggie_tpu_torch.ops.morphology as tmorph
import test_torch_inst_dense as tid
import test_torch_mgm as tmgm
import test_torch_sparsemat as tsm
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.models import remat
from test_torch_harness import jax_step_lock, one_torch_thread  # noqa: F401
from test_torch_mgm import _cli, _data_opts, him_root  # noqa: F401
from test_torch_tcvom import CLIP
from test_torch_train import FLAGS
from test_torch_video_train import _keeping_grads

CONFIGS = ("mgm_stacked", "mgm_tcvom", "sparsemat_image", "dense")
MODES = ("full", "selective")
SEGMENTS = {"mgm_stacked": 3, "mgm_tcvom": 2, "sparsemat_image": 1, "dense": 3}
JAX_MODE = "none"             # (b): the JAX step that both modes are held against
_PORT_DILATE = tmorph.dilate_ellipse_random


def _widths(n: int) -> dict:
    """The fusion's widths by dilation size: k=30, then k=15, ``n`` maps each."""
    return {k: np.random.RandomState(k).randint(1, k, n) for k in (30, 15)}


def _case(name: str):
    """The config's JAX model, variables and batch, its port model (eval
    mode, as built), config, batch, widths and the family's step check."""
    if name in ("mgm_stacked", "mgm_tcvom"):
        jcfg, jm, jv, tm, _ = tmgm.build_pair(name, head_scale=tmgm.TRAIN_HEAD_SCALE)
        keys = tmgm.LOSS_KEYS + ("total",)
        if name == "mgm_stacked":
            jb, tb = tmgm.train_batch()
        else:
            jb, tb = tmgm.global_train_batch(tmgm.TCVOM_SEEDS, n_f=CLIP, slots=1, n_i=1)
            keys = keys[:-1] + tuple(f"loss_dtSSD{s}" for s in ("", "_os1", "_os4", "_os8")) + (
                "loss_atten", "total")
        widths = _widths(int(np.prod(tb["alpha"].shape[:3])))
        check = lambda js, jld, st, tld, g: tmgm.check_step(js, jld, st, tld, g, keys)
    elif name == "sparsemat_image":
        jcfg, jm, jv, tm, _ = tsm.build_pair()
        jb, tb = tsm.train_batch()
        widths, check = None, tsm.check_train_step
    else:
        jcfg, jm, jv, tm, _ = tid.build_pair(seed=1, head_scale=tid.TRAIN_HEAD_SCALE)
        jb, tb = tmgm.global_train_batch(tmgm.DENSE_SEEDS)
        widths, check = _widths(int(np.prod(tb["alpha"].shape[:3]))), tid.check_train_step
    return SimpleNamespace(name=name, jcfg=jcfg, jm=jm, jv=jv, jb=jb, model=tm,
                           pcfg=ConfigNode(jcfg.to_dict()), tb=tb, widths=widths, check=check,
                           steps={}, jax=None)


@pytest.fixture(scope="module")
def cases():
    """Each config's case, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _case(name)
        return built[name]
    return get


def _keyed_dilations(mp, widths: dict) -> None:
    """Both packages' random-width dilations take ``widths[k_size]``."""
    def jax_dilate(binary, k_size, rng):
        return tmgm._jax_dilate_with([widths[k_size]], itertools.count())(binary, k_size, rng)

    def port_dilate(binary, k_size, generator=None):
        return _PORT_DILATE(binary, k_size, widths=torch.from_numpy(widths[k_size]))
    mp.setattr(jmorph, "dilate_ellipse_random", jax_dilate)
    mp.setattr(tmorph, "dilate_ellipse_random", port_dilate)


def _handed(out) -> list:
    """The NCHW shapes of the tensors a segment hands on."""
    return [tuple(t.shape) for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]


def port_step(c, mode: str, fed_widths: bool):
    """One port step of ``mode`` from the config's weights: the loss dict,
    the gradients before the clip, the state dict after, the generator's
    state before and after, the train state, and what each
    ``remat.Stages`` segment returned (the shapes of the tensors handed on;
    the last one's output and loss keys). The fusion's widths are drawn
    from a seeded step generator (memoised in ``c.steps``, without the
    train state), or fed as ``c.widths`` (``fed_widths``)."""
    if not fed_widths and mode in c.steps:
        return c.steps[mode]
    model = copy.deepcopy(c.model).train()
    opt, schedule = build_optimizer(c.pcfg, model.parameters())
    state = ts.TrainState(model, opt)
    grads, segments = {}, []
    clip, checkpointed = ts.clip_by_global_norm_, remat.checkpointed

    def before_clip(gs):
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return clip(gs)

    def segment(fn, *args, **kwargs):
        out = checkpointed(fn, *args, **kwargs)
        segments.append(out)
        return out
    g = torch.Generator().manual_seed(5)
    start = g.get_state()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "clip_by_global_norm_", before_clip)
        mp.setattr(remat, "checkpointed", segment)
        if fed_widths and c.widths is not None:
            _keyed_dilations(mp, c.widths)
        ld = ts.make_train_step(model, opt, schedule, remat=mode)(state, c.tb, g, **FLAGS)
    out = dict(ld=ld, grads=grads, sd=copy.deepcopy(model.state_dict()), start=start,
               generator=g.get_state(), state=state, segments=len(segments),
               handed=[_handed(o) for o in segments[:-1]],
               last_keys=[sorted(d) for d in segments[-1]] if segments else [])
    if not fed_widths:
        c.steps[mode] = {k: v for k, v in out.items() if k != "state"}
    return out


def jax_step(c, mode: str = "none", lock: str | None = None):
    """JAX ``make_train_step(remat=mode)`` from ``c``'s weights on its batch
    ``c.jb``, the fusion's widths fed as ``c.widths``: (state after, loss
    dict); the optimizer hands back the gradients it received
    (``_keeping_grads``). Computed under ``jax_step_lock(lock)`` where
    another file computes the same step."""
    tx = _keeping_grads(jax_build_optimizer(c.jcfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=c.jv["params"],
                           opt_state=jax.jit(tx.init)(c.jv["params"]),
                           batch_stats=c.jv["batch_stats"], spectral=c.jv.get("spectral", {}))
    held = contextlib.nullcontext() if lock is None else jax_step_lock(lock)
    with pytest.MonkeyPatch.context() as mp, held:
        if c.widths is not None:
            _keyed_dilations(mp, c.widths)
        return jax_make_train_step(c.jm, tx, remat=mode)(jstate, c.jb, jax.random.PRNGKey(1),
                                                          **FLAGS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CONFIGS)
def test_remat_step_bit_equals_plain(cases, name, mode):
    """(a) Bit for bit, the fusion's widths drawn from the step generator (its
    state reset for the recompute); the generator moved (SparseMat draws
    nothing) and ends where the plain step's ends."""
    c = cases(name)
    want, got = port_step(c, "none", False), port_step(c, mode, False)
    assert set(got["ld"]) == set(want["ld"])
    for k, v in want["ld"].items():
        assert torch.equal(got["ld"][k], v), ("loss", k)
    assert set(got["grads"]) == set(want["grads"])
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), ("gradient", k)
    assert set(got["sd"]) == set(want["sd"])
    assert any(k.endswith("num_batches_tracked") for k in want["sd"])
    for k, v in want["sd"].items():     # parameters, BatchNorm buffers, u/v
        assert torch.equal(got["sd"][k], v), ("state", k)
    assert torch.equal(got["generator"], want["generator"])
    assert torch.equal(want["generator"], want["start"]) == (name == "sparsemat_image")
    moved = [k for k, v in c.model.state_dict().items() if k.endswith("running_mean")
             and not torch.equal(want["sd"][k], v)]
    assert moved, "no BatchNorm statistic stepped"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CONFIGS)
def test_remat_step_matches_jax(cases, name, mode):
    """(b) The remat step against JAX's ``JAX_MODE`` step (one a config), at
    the family's tolerances, with the family's margins from the discrete
    thresholds: K2's (the dense decoder's ``detail_mask``, read in the first
    pass and again in the recompute) and SparseMat's active set."""
    c = cases(name)
    jstate, jld = jax_reference(c)
    if name == "dense":
        with tmgm.k2_margins(3, module=tdense) as margins:
            got = port_step(c, mode, True)
        assert len(margins) == 2 and min(margins) >= tmgm.MARGIN, margins
    elif name == "sparsemat_image":
        with tsm.Margins() as rec:
            got = port_step(c, mode, True)
        assert len(rec.alpha) == 2 and min(rec.alpha) >= tsm.MARGIN, rec.alpha
    else:
        got = port_step(c, mode, True)
    c.check(jstate, jld, got["state"], got["ld"], got["grads"])


def jax_reference(c):
    """``jax_step(c, JAX_MODE)``, run once a config; its trace of the train
    forward records the NHWC shapes of the tensors the JAX package tags
    ``checkpoint_name(x, "stage")`` into ``c.tags``."""
    if c.jax is None:
        shapes = []
        tag = jax.ad_checkpoint.checkpoint_name

        def recording(x, name):
            assert name == "stage", name
            shapes.append(tuple(x.shape))
            return tag(x, name)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.ad_checkpoint, "checkpoint_name", recording)
            # the family's own train-step test computes the same step
            c.jax = jax_step(c, JAX_MODE, lock=c.name)
        c.tags = shapes
    return c.jax


@pytest.mark.parametrize("name", CONFIGS)
def test_selective_segments_end_at_jax_tags(cases, name):
    """(c) The selective step's segments: their count, the tensors handed on
    by every segment but the last against the JAX tags, and the last one's
    ``(output, loss_dict)``."""
    c = cases(name)
    step = port_step(c, "selective", False)
    assert step["segments"] == SEGMENTS[name]
    handed = [shape for seg in step["handed"] for shape in seg]
    assert all(len(shape) == 4 for shape in handed)
    nhwc = sorted((n, h, w, ch) for n, ch, h, w in handed)
    jax_reference(c)
    tags = c.tags
    assert nhwc == sorted(tags), (nhwc, tags)
    output_keys, loss_keys = step["last_keys"]
    assert "refined_masks" in output_keys and "total" in loss_keys


def test_cli_selective_trains_as_none(him_root, tmp_path):
    """``main --config configs/mgm_stacked.yaml --device cpu`` with
    ``model.remat selective`` and with ``none``, two iterations at batch
    2: the same parameters and buffers, bit for bit (the fusion's widths
    are drawn from the step generator)."""
    states = {}
    for mode in ("none", "selective"):
        states[mode] = _cli("mgm_stacked", *_data_opts(him_root, tmp_path / mode),
                            "train.batch_size", "2", "train.max_iter", "2",
                            "train.val_iter", "1000", "model.remat", mode)
    assert states["none"].step == states["selective"].step == 2
    want = states["none"].model.state_dict()
    got = states["selective"].model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
