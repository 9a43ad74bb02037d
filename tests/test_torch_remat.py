"""Rematerialisation of the port's train step (``model.remat`` ``full`` and
``selective``, ``maggie_tpu_torch/models/remat.py``) on the CPU.

The models are ``tests/test_torch_train.py``'s reduced image model (one
128x128 frame, 3 instances in 10 slots) and ``tests/test_torch_video_train.py``'s
reduced video model (3 frames at 64x64, 3 slots), on those files' seeded
variables. The four random-width dilations of a step get widths that depend
only on the dilation's size and its number of maps, on both sides, so that a
recompute that calls them again gets them again.

- A remat step against the port's plain step: every loss term, every
  gradient, the parameters after AdamW, the BatchNorm statistics and
  ``num_batches_tracked``, the spectral-norm u/v and the step generator's
  state afterwards are bit-equal. Once as above (``inst_spec_dropout`` 0),
  once with dropout 0.1 and the dilation widths drawn from the generator,
  so that a redrawn mask would show.
- A remat step against the JAX package's plain ``make_train_step``, with
  the JAX optimizer wrapped to hand back the gradients it receives: the
  remat step bit-equal to the port's plain step on the same inputs, and at
  ``tests/test_torch_train.py``'s tolerances from JAX's (loss terms rtol
  1e-5, the video os8 terms 5e-4 as ``tests/test_torch_video_train.py``
  explains, gradients 5e-2 relative L2, parameters within 2 lr + 1e-6 and
  at most 2% beyond 1e-6, BatchNorm statistics 2e-5, u/v 1e-6, the video
  diff module's 1e-5). JAX's remat modes differ from its plain step only in
  what they keep for the backward, so one JAX step a kind, compiled once
  for the module, serves both modes (as ``test_torch_baseline_remat.py``
  does), and it is the step ``tests/test_torch_train.py`` and
  ``tests/test_torch_video_train.py`` compile (the same weights, batch,
  widths and optimizer), which the persistent compile cache may share.
- The recompute takes the blocks the first pass took (``remat.check_replay``),
  and that check raises when the recompute's blocks differ.
- Each replay is needed: with the spectral-norm replay, the BatchNorm skip or
  the generator's reset turned off, the remat step no longer equals the plain
  one.
- ``model.remat`` values: the JAX package's spellings, and any other value
  raises; ``engine.train`` through the CLI with ``model.remat selective``
  leaves the parameters the plain run leaves.
- The oracle ladder's train branch (``sparse_mode: oracle``, masked
  BatchNorm statistics over ``mask``) against the JAX package's at the
  same tolerances, and its selective remat (stages 4 to 6 as one) bit-equal
  to its plain step.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.engine.train_step as ts
import maggie_tpu_torch.models.layers as tlayers
import maggie_tpu_torch.models.decoder_sparse as tdecoder
import maggie_tpu_torch.ops.morphology as tmorph
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.main import main
from maggie_tpu_torch.models import build_model, remat
from maggie_tpu_torch.utils.convert_jax import convert_jax, to_jax
from test_torch_harness import (jax_step_lock, jax_variables, one_torch_thread,  # noqa: F401
                                random_flat)
from test_torch_train import (FLAGS, LOSS_RTOL, _check_grads, _check_state, _flat, train_batch,
                              train_cfg)
from test_torch_train_engine import CONFIG, _opts, him_root  # noqa: F401
from test_torch_video_train import (DIFF_ATOL, LR, OS8_LOSS_RTOL, _keeping_grads, _os8_term,
                                    clip_batch, train_video_cfg)

KINDS = ("image", "video", "oracle")
MODES = ("full", "selective")
_PORT_DILATE = tmorph.dilate_ellipse_random


def _widths(k_size: int, n: int) -> np.ndarray:
    return np.random.RandomState(k_size).randint(1, k_size, n)


def _jax_dilate(binary, k_size, rng):
    """The JAX package's ``dilate_ellipse_random`` (``morphology.py:154-170``)
    with ``_widths`` instead of its draw."""
    lead = binary.shape[:-2]
    n = int(np.prod(lead))
    h, w = binary.shape[-2:]
    buf = jmorph._odd_buf(k_size - 1)
    bank = np.stack([jmorph._embedded_offset_kernel(wd, buf) for wd in range(1, k_size)], 0)
    y = jax.lax.conv_general_dilated(
        binary.reshape((1, n, h, w)).astype(jnp.float32),
        jnp.asarray(bank[_widths(k_size, n) - 1])[:, None], window_strides=(1, 1),
        padding=[(buf // 2, buf // 2)] * 2, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=n)
    return (y > 0.0).reshape(binary.shape).astype(binary.dtype)


def _port_dilate(binary, k_size, generator=None):
    n = int(np.prod(binary.shape[:-2]))
    return _PORT_DILATE(binary, k_size, widths=torch.from_numpy(_widths(k_size, n)))


def _cfg(kind):
    cfg = train_video_cfg() if kind == "video" else train_cfg()
    if kind == "oracle":
        cfg.model.decoder_args.sparse_mode = "oracle"
    return cfg


@pytest.fixture(scope="module")
def setup():
    """Per kind: the JAX model, its optimizer (handing back its gradients),
    the JAX train state, the port config and the port model's state dict on
    the same variables, and the memos of its port steps and its JAX step;
    the dilation widths patched on both sides."""
    out = {}
    for kind in KINDS:
        cfg = _cfg(kind)
        pcfg = ConfigNode(cfg.to_dict())
        model = build_model(pcfg.model, device="cpu")
        shapes = {k: v.shape for k, v in to_jax(model.state_dict()).items()}
        flat = random_flat(dict(sorted(shapes.items())), seed=10 if kind == "video" else 8)
        model.load_state_dict(convert_jax(flat, model))
        variables = jax_variables(flat)
        jm = jax_build_model(cfg.model)
        tx = _keeping_grads(jax_build_optimizer(cfg)[0])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               opt_state=jax.jit(tx.init)(variables["params"]),
                               batch_stats=variables["batch_stats"],
                               spectral=variables["spectral"])
        out[kind] = dict(jm=jm, tx=tx, jstate=jstate, pcfg=pcfg,
                         sd=copy.deepcopy(model.state_dict()), steps={}, jax=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random", _jax_dilate)
        mp.setattr(tmorph, "dilate_ellipse_random", _port_dilate)
        yield out


def _batch(kind):
    return clip_batch() if kind == "video" else train_batch()


def _port_step(setup, kind, mode, dropout=None, seed=5, draws=False, memo=True):
    """One port step of ``mode`` from the kind's variables: the loss dict,
    the gradients before the clip, the state dict after the step, the
    generator's state after it, and the train state. ``draws``: the
    dilation widths drawn from the step generator (else fed by size).
    Memoised a kind by (mode, dropout, seed, draws); ``memo=False`` for a
    test that patches the step's internals."""
    s = setup[kind]
    key = (mode, dropout, seed, draws)
    if memo and key in s["steps"]:
        return s["steps"][key]
    model = build_model(s["pcfg"].model, device="cpu")
    model.load_state_dict(s["sd"])
    model.train()
    if dropout is not None:
        model.decoder.inst_spec_layer.dropout = dropout
    tb = _batch(kind)[1]
    grads, clip = {}, ts.clip_by_global_norm_

    def before_clip(gs):
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()})
        return clip(gs)
    opt, schedule = build_optimizer(s["pcfg"], model.parameters())
    state = TrainState(model, opt)
    g = torch.Generator().manual_seed(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "clip_by_global_norm_", before_clip)
        if draws:
            mp.setattr(tmorph, "dilate_ellipse_random", _PORT_DILATE)
        ld = make_train_step(model, opt, schedule, remat=mode)(state, tb, g, **FLAGS)
    out = dict(ld=ld, grads=grads, sd=model.state_dict(), generator=g.get_state(), state=state)
    if memo:
        s["steps"][key] = out
    return out


def _assert_bit_equal(want, got):
    assert set(got["ld"]) == set(want["ld"])
    for k, v in want["ld"].items():
        assert torch.equal(got["ld"][k], v), ("loss", k)
    for k, v in want["grads"].items():
        assert torch.equal(got["grads"][k], v), ("gradient", k)
    assert set(got["sd"]) == set(want["sd"])
    assert any(k.endswith("num_batches_tracked") for k in want["sd"])
    for k, v in want["sd"].items():     # parameters, BatchNorm buffers, u/v
        assert torch.equal(got["sd"][k], v), ("state", k)
    assert torch.equal(got["generator"], want["generator"])


@pytest.mark.parametrize("draws", [False, True], ids=["fixed_draws", "generator_draws"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["image", "video"])
def test_remat_step_bit_equals_plain(setup, kind, mode, draws):
    dropout = 0.1 if draws else None
    want = _port_step(setup, kind, "none", dropout, draws=draws)
    got = _port_step(setup, kind, mode, dropout, draws=draws)
    _assert_bit_equal(want, got)
    if draws:   # the draws reach the result: another seed moves it
        other = _port_step(setup, kind, "none", dropout, seed=6, draws=True)
        assert not torch.equal(other["ld"]["total"], want["ld"]["total"])


def _jax_step(setup, kind):
    """The kind's JAX plain step (state after, loss dict), compiled and run
    once for the module."""
    s = setup[kind]
    if s["jax"] is None:
        step = jax_make_train_step(s["jm"], s["tx"])
        # the image step is test_torch_train.py's, the video step
        # test_torch_video_train.py's (test_torch_harness.jax_step_lock)
        with jax_step_lock(kind):
            s["jax"] = step(s["jstate"], _batch(kind)[0], jax.random.PRNGKey(1), **FLAGS)
    return s["jax"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["image", "video"])
def test_remat_step_matches_jax(setup, kind, mode):
    """The remat step bit-equal to the plain one (fed widths, no dropout)
    and both against JAX's step at the tolerances above. The steps draw
    nothing from their generator (asserted), so its seed is immaterial and
    they are the fixed-draws steps of ``test_remat_step_bit_equals_plain``."""
    jstate, jld = _jax_step(setup, kind)
    got = _port_step(setup, kind, mode)
    _assert_bit_equal(_port_step(setup, kind, "none"), got)
    assert torch.equal(got["generator"], torch.Generator().manual_seed(5).get_state())
    assert set(got["ld"]) == set(jld), sorted(set(got["ld"]) ^ set(jld))
    for k, v in jld.items():
        tol = OS8_LOSS_RTOL if kind == "video" and _os8_term(k) else LOSS_RTOL
        np.testing.assert_allclose(float(got["ld"][k]), float(v), rtol=tol, err_msg=k)
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(got["grads"]))
    assert got["state"].step == int(jstate.step) == 1
    _check_state(jstate, got["state"], lr=LR)
    if kind == "video":
        for name in ("batch_stats", "spectral"):
            want = {k: v for k, v in _flat(name, getattr(jstate, name)).items()
                    if "diff_module" in k}
            have = to_jax(getattr(got["state"], name)())
            assert len(want) == 4
            for k, v in want.items():
                np.testing.assert_allclose(have[k], v, rtol=0, atol=DIFF_ATOL, err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["image", "video"])
def test_recompute_takes_the_first_pass_blocks(setup, monkeypatch, kind, mode):
    """One compared recompute of ``select_blocks`` per forward; a recompute
    whose blocks differ (the valid flags turned off) raises."""
    monkeypatch.setattr(remat, "check_replay", True)
    monkeypatch.setattr(remat, "replay_checks", 0)
    _port_step(setup, kind, mode, memo=False)
    assert remat.replay_checks == 1        # the step's one forward

    select, calls = tdecoder.select_blocks, []

    def second_differs(mask, block, cap):
        idx_n, idx_by, idx_bx, valid = select(mask, block, cap)
        calls.append(1)
        return idx_n, idx_by, idx_bx, valid & (len(calls) == 1)
    monkeypatch.setattr(tdecoder, "select_blocks", second_differs)
    with pytest.raises(RuntimeError, match="recompute's blocks differ"):
        _port_step(setup, kind, mode, memo=False)


def _naive_recompute(self):
    """``_Record.recompute`` without the generator's reset."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        remat._stacks.replaying.append(remat._Replay(self))
        try:
            yield
        finally:
            remat._stacks.replaying.pop()
    return cm()


@pytest.mark.parametrize("hazard", ["spectral_norm", "batchnorm", "generator"])
def test_each_replay_is_needed(setup, monkeypatch, hazard):
    """The video step under selective remat with one replay turned off: the
    spectral norms step again from the u the first pass wrote (u/v and the
    gradients move), BatchNorm steps its statistics twice, or the recompute
    draws anew from the generator (the gradients and the generator's state
    move). The test sees each hazard."""
    want = _port_step(setup, "video", "none", dropout=0.1, draws=True)
    if hazard == "spectral_norm":
        monkeypatch.setattr(tlayers.remat, "sn_replay", lambda: None)
    elif hazard == "batchnorm":
        monkeypatch.setattr(remat, "replaying", lambda: False)
    else:
        monkeypatch.setattr(remat._Record, "recompute", _naive_recompute)
    got = _port_step(setup, "video", "selective", dropout=0.1, draws=True, memo=False)
    moved = {k for k, v in want["sd"].items() if not torch.equal(got["sd"][k], v)}
    grads_moved = any(not torch.equal(got["grads"][k], v) for k, v in want["grads"].items())
    if hazard == "spectral_norm":
        assert any(k.endswith(("weight_u", "weight_v")) for k in moved) and grads_moved
    elif hazard == "batchnorm":
        assert any(k.endswith(("running_mean", "running_var")) for k in moved)
    else:
        assert grads_moved and not torch.equal(got["generator"], want["generator"])


def test_remat_values():
    """The JAX package's spellings of ``model.remat``; any other value
    raises and names the allowed ones (the JAX package takes any other
    truthy string for "full")."""
    for value, mode in ((False, "none"), ("none", "none"), ("False", "none"), (None, "none"),
                        (True, "full"), ("full", "full"), ("True", "full"),
                        ("selective", "selective")):
        assert remat.remat_mode(value) == mode, value
    model = build_model(ConfigNode(train_cfg().to_dict()).model, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    for value in ("sometimes", "Selectiv", 2):
        with pytest.raises(ValueError, match="must be one of"):
            make_train_step(model, opt, lambda s: 0.1, remat=value)


def test_cli_selective_trains_as_none(him_root, tmp_path):
    """``main.main`` on the CPU, two iterations with ``model.remat
    selective`` and with ``none``: the same parameters and buffers, bit for
    bit (the image config's dropout 0.1 and the random dilation widths
    draw from the step generator)."""
    states = {}
    for mode in ("none", "selective"):
        states[mode] = main(["--config", CONFIG, "--device", "cpu"]
                            + _opts(him_root, tmp_path / mode, "train.max_iter", "2",
                                    "train.val_iter", "1000", "model.remat", mode))
    assert states["none"].step == states["selective"].step == 2
    want = states["none"].model.state_dict()
    got = states["selective"].model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_oracle_train_step_matches_jax(setup):
    """The oracle ladder's train branch (``predict_details``, masked
    BatchNorm statistics over ``mask``): one step against the JAX package's,
    plain on both sides, at ``tests/test_torch_train.py``'s tolerances."""
    jstate, jld = _jax_step(setup, "oracle")
    got = _port_step(setup, "oracle", "none", seed=1)
    assert set(got["ld"]) == set(jld)
    for k, v in jld.items():
        np.testing.assert_allclose(float(got["ld"][k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(got["grads"]))
    _check_state(jstate, got["state"], lr=LR)


@pytest.mark.parametrize("mode", MODES)
def test_oracle_remat_step_bit_equals_plain(setup, mode):
    _assert_bit_equal(_port_step(setup, "oracle", "none", dropout=0.1, draws=True),
                      _port_step(setup, "oracle", mode, dropout=0.1, draws=True))
