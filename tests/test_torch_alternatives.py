"""The port's off-by-default alternatives against ``maggie_tpu`` with the same
flag, on the CPU: ``encoder_args.s2d_stem``, ``encoder_args.lazy_os2_shortcut``,
``decoder_args.phase_rung`` and ``decoder_args.atten_stride`` 2.

Sizes are the harness's (``test_torch_harness.py``): a 128x192 frame with 2
instances, attention and final channels 32, weights from ``random_flat`` on
the variable shapes of the port's tree (``port_shapes``; the first three
flags add no parameter), batches from a numpy seed.

- ``s2d_stem``: the JAX package runs the stem conv on the space-to-depth
  input, the port the ordinary conv (it builds the default model); the eval
  forward within 1e-5, and the
  encoder in train mode: the stem's skip maps within 1e-5 of their scale,
  the deeper maps within 1e-4 relative L2, the VJP of a random cotangent
  within ``test_torch_train.py``'s relative-L2 limit of a chained net, 5e-2.
  The encoder is ~30 train-mode BatchNorms deep, the chain that test's
  docstring measures: its os16 and os32 maps drift by 2.9e-5 relative L2
  from JAX's with and without JAX's space-to-depth stem alike.
- ``lazy_os2_shortcut``: the JAX package's patch form of ``shortcut.1``
  equals its dense branch bit for bit (``tests/test_blocksparse.py:91-113``),
  so the port runs the dense branch: the image forward within 1e-5 of JAX's
  lazy form, bit-equal to the port's default with the default's K1 calls;
  the ``ValueError`` off ``block`` mode.
- ``phase_rung``: at full capacity, the JAX package's phase-space rung 3 is a
  reassociated sum, so the os1 and fused alphas are held to the bound the
  JAX package allows between its two forms (max 2e-3, mean 1e-5,
  ``tests/test_blocksparse.py:76-81``) and the os8 and os4 alphas, which
  rung 3 does not touch, to 1e-5; the port's two forms run the same modules
  on the same windows there, so its phase form equals its default within
  1e-5 on every output. At a capacity that overflows (a quarter
  of the blocks: at half, no dropped block borders a kept one here), the
  JAX package's phase form differs from its default by up to 5e-2, because
  its dense hand-off reads zeros where the default recomputes a dropped
  neighbour's halo; the port's two forms differ at the same pixels, and each
  stays within its bound of JAX's. The ``ValueError`` with an explicit
  ``lazy_os1_shortcut``.
- ``atten_stride`` 2: the JAX package cannot run it as it stands: after the
  attended map is resized back to the os8 size, its instance decoder
  reshapes it with the pooled size (``maggie_tpu/models/instance_decoder.py
  :225,239,242``) and fails. The port keeps the os8 size there, and these
  tests hold it to the JAX package's own code with that one line mended
  (``mended``: the source of ``InstanceMatteDecoder.__call__`` with the size
  taken again after the add, in a subclass that the JAX decoders build
  while the fixture is active; nothing of the JAX package changes). The
  image, dense-ablation and video forwards within 1e-5; a train step (with ``s2d_stem`` too) at ``test_torch_train.py``'s
  tolerances, the attention loss among the loss terms; ``selective`` remat
  bit-equal to the plain step; ``convert_jax`` carrying ``ori_feat_proj``
  and the ``.pth`` load refusing a file without it; the ``ValueError`` on
  an os8 size the stride does not divide.
- One video window (lazy os2, the phase rung and stride 2 together, to keep
  the JAX compiles few) through the port's feature cache against JAX's
  forward on the same frames.
- The CLI (``python -m maggie_tpu_torch.main --eval-only --device cpu``) with
  all four flags as overrides of ``configs/maggie_image.yaml``.
"""

import copy
import inspect
import itertools
import re
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import maggie_tpu.models.decoder_inst_dense as jdense
import maggie_tpu.models.decoder_sparse as jsparse
import maggie_tpu.models.instance_decoder as jid
import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.models.decoder_inst_dense as tdense
import maggie_tpu_torch.models.decoder_sparse as ds
import maggie_tpu_torch.models.maggie as tmaggie
import maggie_tpu_torch.ops.morphology as tmorph
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.ops.resize import avg_pool2d
from maggie_tpu_torch.utils.checkpoint import load_model_weights
from maggie_tpu_torch.utils.convert_jax import convert_jax, flatten_collections, to_jax
from test_torch_harness import (jax_cfg, jax_variables, make_batch, memo,  # noqa: F401
                                one_torch_thread, port_cfg, port_from_flat, random_flat)
from test_torch_engine import CONFIG, MODEL_OPTS, _opts, him_root  # noqa: F401
from test_torch_inst_dense import SCALED, dense_cfg, frame
from test_torch_mgm import MARGIN, k2_margins
from test_torch_train import (FLAGS, _check_grads, _check_losses, _check_state, _flat,
                              _jax_dilate_with_widths, _keeping_grads, _port_dilate_with_widths,
                              port_step_keeping_grads, train_batch, train_cfg)
from test_torch_video import (assert_margins, close, threshold_margins, video_cfg,
                              window)

ATOL = 1e-5
PHASE_MAX, PHASE_MEAN = 2e-3, 1e-5     # tests/test_blocksparse.py:76-81
GRAD_REL_L2 = 5e-2                     # test_torch_train.py's chained-net limit
FWD_REL_L2 = 1e-4                      # train-mode encoder maps past fea2 (the docstring)
OVERFLOW_CAP = 0.25
KEYS = ("refined_masks", "alpha_os1", "alpha_os4", "alpha_os8")
LR = 1.5e-4 / 25                       # test_torch_train.py's first cosine step


def flagged(jcfg, **flags):
    """``jcfg`` with each flag set where the model reads it."""
    for k, v in flags.items():
        args = jcfg.model.encoder_args if k in ("s2d_stem", "lazy_os1_shortcut",
                                                "lazy_os2_shortcut") else jcfg.model.decoder_args
        args[k] = v
    return jcfg


def port_shapes(jcfg) -> dict:
    """The variable shapes of ``jcfg``'s model, from the port's own tree
    through ``to_jax`` (the JAX package's tree, key for key: its apply
    raises on any key it lacks), without tracing the JAX init."""
    model_cfg = port_cfg(jcfg)
    return memo(f"port_shapes {model_cfg!r}", lambda: {
        k: v.shape for k, v in to_jax(port_build_model(model_cfg, device="cpu")
                                      .state_dict()).items()})


@pytest.fixture(scope="module")
def flat():
    """The default model's seeded variables (no flag but the stride adds one)."""
    return random_flat(port_shapes(jax_cfg()), 0)


_ADD = "            fm = ori_feat + fm\n"


@pytest.fixture(scope="module")
def mended():
    """The JAX decoders build ``InstanceMatteDecoder`` with its size taken
    again after the stride's resize and add (the module docstring); with
    stride 1 the subclass is the class itself."""
    src = textwrap.dedent(inspect.getsource(jid.InstanceMatteDecoder.__call__))
    assert src.count(_ADD[4:]) == 1, "the JAX instance decoder changed: revisit this mend"
    src = src.replace(_ADD[4:], _ADD[4:] + "        h, w = fm.shape[1], fm.shape[2]\n")
    scope = dict(vars(jid))
    exec(compile(src, jid.__file__, "exec"), scope)
    cls = type("InstanceMatteDecoder", (jid.InstanceMatteDecoder,),
               {"__call__": scope["__call__"], "__module__": jid.__name__})
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jsparse, jdense):
            mp.setattr(mod, "InstanceMatteDecoder", cls)
        yield cls


@pytest.fixture(scope="module")
def stride_flat(mended):
    return random_flat(port_shapes(flagged(jax_cfg(), atten_stride=2)), 0)


def jax_forward(jcfg, flat, jb):
    jm = jax_build_model(jcfg.model)
    return jax.device_get(jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        jax_variables(flat), jb))


def port_forward(jcfg, flat, tb, model=None):
    model = port_from_flat(port_cfg(jcfg), flat) if model is None else model
    with torch.inference_mode():
        return model(tb), model


def assert_matches(tout, jout, keys=KEYS, atol=ATOL, label=""):
    np.testing.assert_array_equal(tout["detail_mask"].numpy(), np.asarray(jout["detail_mask"]),
                                  err_msg=f"{label} detail_mask")
    for k in keys:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=atol,
                                   err_msg=f"{label} {k}")


def assert_phase_bound(tout, jout, label=""):
    """The os1 and fused alphas within the JAX package's bound between its
    two rung-3 forms; the os8 and os4 alphas within 1e-5."""
    assert_matches(tout, jout, ("alpha_os4", "alpha_os8"), label=label)
    for k in ("alpha_os1", "refined_masks"):
        d = np.abs(tout[k].numpy() - np.asarray(jout[k]))
        assert d.max() < PHASE_MAX and d.mean() < PHASE_MEAN, (label, k, d.max(), d.mean())


class GatherSpy:
    """Records every K1 call of the image ladder: (map, block, halo)."""

    def __init__(self, monkeypatch):
        self.calls, orig = [], ds.gather_patches

        def spy(feat, idx_n, idx_by, idx_bx, block, halo):
            self.calls.append((feat, block, halo))
            return orig(feat, idx_n, idx_by, idx_bx, block, halo)
        monkeypatch.setattr(ds, "gather_patches", spy)

    def geometry(self):
        return [(b, h) for _, b, h in self.calls]

    def reads_without_copy(self, geometry, src):
        """The call at ``geometry`` read the NHWC view of ``src``'s memory."""
        feat = {(b, h): f for f, b, h in self.calls}[geometry]
        assert src.is_contiguous() and not feat.is_contiguous(), geometry
        assert feat.data_ptr() == src.data_ptr(), geometry
        assert torch.equal(feat, src.permute(0, 2, 3, 1)), geometry


# ------------------------------------------------------------------ s2d_stem
def test_s2d_stem_eval_matches_jax(flat):
    jcfg = flagged(jax_cfg(), s2d_stem=True)
    jb, tb = make_batch(n_i=2, seed=0)
    tout, model = port_forward(jcfg, flat, tb)
    assert str(model) == str(port_build_model(port_cfg(jax_cfg()), device="cpu"))
    assert_matches(tout, jax_forward(jcfg, flat, jb), label="s2d_stem")


def test_s2d_stem_encoder_train_matches_jax(flat):
    """The encoder alone in train mode (batch statistics, one spectral-norm
    power step): its os32 output and five skip maps, and the VJP of a random
    cotangent on all six, against ``jax.vjp`` of the JAX encoder with its
    space-to-depth stem. The stem's own gradients are the ones that
    space-to-depth rearranges, and they are held alone too."""
    jcfg = flagged(jax_cfg(), s2d_stem=True)
    jm = jax_build_model(jcfg.model)
    v = jax_variables(flat)
    rs = np.random.RandomState(3)
    x = np.concatenate([rs.rand(2, 128, 128, 3),
                        rs.rand(2, 128, 128, 10) > 0.7], axis=-1).astype(np.float32)

    def f(params, x):
        (out, mid), _ = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"], "spectral": v["spectral"]}, x,
            method=lambda m, x: m.encoder(x, train=True, update_sn=True),
            mutable=["batch_stats", "spectral"])
        return (out,) + tuple(mid["shortcut"])
    shapes = jax.eval_shape(f, v["params"], jnp.asarray(x))
    cts = tuple(rs.randn(*s.shape).astype(np.float32) for s in shapes)

    def out_and_vjp(p, c, x):
        y, vjp = jax.vjp(f, p, x)
        return y, vjp(c)
    ys, (jgp, jgx) = jax.jit(out_and_vjp)(v["params"], cts, jnp.asarray(x))

    model = port_from_flat(port_cfg(jcfg), flat)
    enc = model.encoder.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out, mid = enc(tx)
    touts = (out,) + tuple(mid["shortcut"])
    def rel_l2(got, want):
        return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    loss = 0
    for i, (t, y, c) in enumerate(zip(touts, ys, cts)):
        t_nhwc = t.permute(0, 2, 3, 1)
        got, want = t_nhwc.detach().numpy(), np.asarray(y)
        if i in (1, 2):     # fea1 (no stem) and fea2 (the stem, two BatchNorms on)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)
        else:               # deeper in the chain
            assert rel_l2(got, want) <= FWD_REL_L2, (i, rel_l2(got, want))
        loss = loss + (t_nhwc * torch.from_numpy(c)).sum()
    loss.backward()
    assert rel_l2(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx)) <= GRAD_REL_L2
    want = {k: w for k, w in _flat("params", jgp).items() if "/encoder_mod/" in k}
    got = to_jax({k: p.grad for k, p in model.named_parameters() if p.grad is not None})
    assert set(want) <= set(got)
    _check_grads(want, {k: got[k] for k in want})
    stem = "params/encoder_mod/backbone/conv1/weight_bar"
    assert rel_l2(got[stem], want[stem]) <= GRAD_REL_L2, rel_l2(got[stem], want[stem])


# --------------------------------------------------------- lazy_os2_shortcut
def test_lazy_os2_matches_jax_and_its_dense_branch(flat, monkeypatch):
    """The lazy os2 forward within 1e-5 of JAX's and bit-equal to the port's
    dense branch (the default model on the same weights), with the
    default's K1 calls: ``fea2`` gathered at (32, 2), no ``x1`` gather."""
    jcfg = flagged(jax_cfg(), lazy_os2_shortcut=True)
    jb, tb = make_batch(n_i=2, seed=0)
    spy = GatherSpy(monkeypatch)
    lazy, model = port_forward(jcfg, flat, tb)
    assert model.encoder.lazy_os1_shortcut
    default_calls = [(64, 32), (8, 3), (16, 4), (32, 2), (64, 5)]
    assert spy.geometry() == default_calls
    assert_matches(lazy, jax_forward(jcfg, flat, jb), label="lazy os2")
    dense, _ = port_forward(jax_cfg(), flat, tb)
    assert spy.geometry() == default_calls * 2
    assert set(dense) == set(lazy)
    for k in dense:
        assert torch.equal(lazy[k], dense[k]), k


def test_lazy_os2_needs_block_mode(flat):
    jcfg = flagged(jax_cfg(sparse_mode="oracle"), lazy_os2_shortcut=True)
    _, tb = make_batch(n_i=2, seed=0)
    with pytest.raises(ValueError, match="lazy os2 shortcut requires sparse_mode='block'"):
        port_forward(jcfg, flat, tb)


# ---------------------------------------------------------------- phase_rung
def test_phase_rung_full_capacity_matches_jax(flat, monkeypatch):
    """Full capacity: the port's dense hand-off against JAX's phase-space
    rung 3. Its K1 calls: the default's first four, then the os2 hand-off
    buffer (32, 2) and ``fea1`` at os1 halo 4, read without a copy; lazy
    os1 is off with the phase rung, as in JAX."""
    jcfg = flagged(jax_cfg(cap_frac=1.0), phase_rung=True)
    jb, tb = make_batch(n_i=2, seed=0)
    spy, enc = GatherSpy(monkeypatch), {}
    model = port_from_flat(port_cfg(jcfg), flat)
    assert model.decoder.phase_rung and not model.encoder.lazy_os1_shortcut
    handle = model.encoder.register_forward_hook(
        lambda _m, _i, out: enc.update(fea1=out[1]["shortcut"][0]))
    try:
        tout, _ = port_forward(jcfg, flat, tb, model)
    finally:
        handle.remove()
    assert spy.geometry() == [(64, 32), (8, 3), (16, 4), (32, 2), (32, 2), (64, 4)]
    spy.reads_without_copy((64, 4), enc["fea1"])
    hand_off = spy.calls[4][0]
    assert hand_off.is_contiguous() and hand_off.shape == (2, 64, 96, 32)
    assert_phase_bound(tout, jax_forward(jcfg, flat, jb), "full capacity")
    default, _ = port_forward(jax_cfg(cap_frac=1.0), flat, tb)
    assert set(default) == set(tout)
    for k in default:
        np.testing.assert_allclose(tout[k].numpy(), default[k].numpy(), rtol=0, atol=ATOL,
                                   err_msg=f"phase rung vs the port's default: {k}")


def test_phase_rung_overflow_takes_the_dense_hand_off(flat):
    """A quarter of the blocks: both packages' phase forms differ from their
    defaults at the same pixels, by far more than the forms' bound, and
    each form stays within its bound of JAX's."""
    jb, tb = make_batch(n_i=2, seed=0)
    base = lambda: jax_cfg(cap_frac=OVERFLOW_CAP)
    outs = {}
    for phase in (False, True):
        jcfg = flagged(base(), phase_rung=phase)
        outs[phase] = jax_forward(jcfg, flat, jb), port_forward(jcfg, flat, tb)[0]
    (jd, td), (jp, tp) = outs[False], outs[True]
    assert_matches(td, jd, label="default")
    assert_phase_bound(tp, jp, "phase")
    jdiff = np.abs(np.asarray(jp["alpha_os1"]) - np.asarray(jd["alpha_os1"]))
    tdiff = (tp["alpha_os1"] - td["alpha_os1"]).abs().numpy()
    assert jdiff.max() > 20 * PHASE_MAX, jdiff.max()
    # the same pixels, except where JAX's difference lies within the two
    # forms' bounds of the threshold
    cut = 10 * PHASE_MAX
    clear = np.abs(jdiff - cut) > PHASE_MAX + ATOL
    np.testing.assert_array_equal((tdiff > cut)[clear], (jdiff > cut)[clear])
    assert int((jdiff > cut).sum()) > 10


def test_phase_rung_refuses_explicit_lazy_os1(flat):
    jcfg = flagged(jax_cfg(), phase_rung=True, lazy_os1_shortcut=True)
    _, tb = make_batch(n_i=2, seed=0)
    with pytest.raises(ValueError, match="without phase_rung"):
        port_forward(jcfg, flat, tb)


# -------------------------------------------------------------- atten_stride
def test_atten_stride_sparse_matches_jax(stride_flat):
    jcfg = flagged(jax_cfg(), atten_stride=2)
    jb, tb = make_batch(n_i=2, seed=0)
    tout, model = port_forward(jcfg, stride_flat, tb)
    assert model.decoder.refine_OS8.atten_stride == 2
    assert_matches(tout, jax_forward(jcfg, stride_flat, jb), label="atten_stride 2")


def test_atten_stride_dense_decoder_matches_jax(mended):
    """The dense InstMatt ablation decoder with the stride, heads scaled as
    ``test_torch_inst_dense.py`` scales them; K2's inputs off its
    thresholds."""
    jcfg = flagged(dense_cfg(), atten_stride=2)
    flat = random_flat(port_shapes(jcfg), 0)
    for k in flat:
        if any(re.fullmatch(p, k) for p in SCALED):
            flat[k] = flat[k] * np.float32(4.0)
    jb, tb, _ = frame()
    with k2_margins(2, module=tdense) as own, k2_margins(2, module=tmaggie) as fusion:
        tout, _ = port_forward(jcfg, flat, tb)
    assert min(own + fusion) >= MARGIN, (own, fusion)
    assert_matches(tout, jax_forward(jcfg, flat, jb), label="dense atten_stride 2")


def test_atten_stride_refuses_a_size_it_does_not_divide(flat):
    """Stride 3 on the 128x192 frame's 16x24 os8 map: the JAX package would
    fail at the add of the 15x24 attended map; the port names the sizes."""
    jcfg = flagged(jax_cfg(), atten_stride=3)
    model = port_build_model(port_cfg(jcfg), device="cpu")
    _, tb = make_batch(n_i=2, seed=0)
    with pytest.raises(ValueError, match=r"atten_stride 3 .* got 16x24: .* 15x24"):
        with torch.inference_mode():
            model(tb)


def test_atten_stride_pools_bf16_in_f32():
    """The stride's average pool sums in f32 and rounds once to bf16."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16, 24).astype(np.float32))
    got = avg_pool2d(x.bfloat16(), 2)
    want = torch.nn.functional.avg_pool2d(x.bfloat16().float(), 2).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


PROJ = "decoder.refine_OS8.ori_feat_proj.weight"
JAX_PROJ = "params/decoder_mod/refine_OS8_mod/ori_feat_proj/weight"


@pytest.mark.parametrize("decoder", ["res_shortcut_inst_matt_spconv_22",
                                     "res_shortcut_inst_matt_22",
                                     "res_shortcut_inst_matt_spconv_temp_22"])
def test_convert_jax_carries_ori_feat_proj(decoder, tmp_path):
    """The image, dense and video decoders with the stride: ``to_jax`` writes
    the projection under the JAX name (HWIO), ``convert_jax`` carries it
    back; a ``.pth`` without it raises naming it, one with it loads."""
    jcfg = flagged(video_cfg() if "temp" in decoder else jax_cfg(), atten_stride=2)
    jcfg.model.decoder = decoder
    pcfg = ConfigNode(jcfg.to_dict())
    model = port_build_model(pcfg.model, device="cpu")
    sd = model.state_dict()
    w = sd[PROJ]
    assert w.shape == (32, 128, 1, 1)
    flat = to_jax(sd)
    np.testing.assert_array_equal(flat[JAX_PROJ], np.transpose(w.numpy(), (2, 3, 1, 0)))
    flat[JAX_PROJ] = flat[JAX_PROJ] + 1.0
    back = convert_jax(flat, model)
    np.testing.assert_array_equal(back[PROJ].numpy(), w.numpy() + 1.0)
    path = str(tmp_path / "w.pth")
    torch.save({k: v for k, v in sd.items() if k != PROJ}, path)
    pcfg.model.weights = path
    with pytest.raises(KeyError, match="ori_feat_proj"):
        load_model_weights(port_build_model(pcfg.model, device="cpu"), pcfg)
    torch.save(back, path)
    loaded = load_model_weights(port_build_model(pcfg.model, device="cpu"), pcfg)
    assert torch.equal(loaded.state_dict()[PROJ], back[PROJ])


# -------------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def train_setup(mended):
    """``test_torch_train.py``'s setup with ``atten_stride`` 2 and ``s2d_stem``."""
    jcfg = flagged(train_cfg(), atten_stride=2, s2d_stem=True)
    jm = jax_build_model(jcfg.model)
    flat = random_flat(port_shapes(jcfg), seed=8)
    variables = jax_variables(flat)
    tx = _keeping_grads(jax_build_optimizer(jcfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           opt_state=jax.jit(tx.init)(variables["params"]),
                           batch_stats=variables["batch_stats"], spectral=variables["spectral"])
    pcfg = ConfigNode(jcfg.to_dict())
    model = port_build_model(pcfg.model, device="cpu")
    model.load_state_dict(convert_jax(flatten_collections(
        params=jstate.params, batch_stats=jstate.batch_stats, spectral=jstate.spectral), model))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random", _jax_dilate_with_widths(itertools.count()))
        mp.setattr(tmorph, "dilate_ellipse_random", _port_dilate_with_widths(itertools.count()))
        yield dict(step=jax_make_train_step(jm, tx), jstate=jstate, pcfg=pcfg,
                   sd=copy.deepcopy(model.state_dict()), model=model)


def _port_state(setup, remat="none"):
    model = setup["model"]
    model.load_state_dict(setup["sd"])
    model.train()
    opt, schedule = build_optimizer(setup["pcfg"], model.parameters())
    return TrainState(model, opt), make_train_step(model, opt, schedule, remat=remat)


def test_atten_stride_train_step_matches_jax(train_setup):
    """Loss terms (the attention loss at the strided 8x8 map among them),
    gradients before clipping and the state after one step, at
    ``test_torch_train.py``'s tolerances."""
    jb, tb = train_batch()
    jstate, jld = train_setup["step"](train_setup["jstate"], jb, jax.random.PRNGKey(1), **FLAGS)
    tstate, step = _port_state(train_setup)
    tld, grads = port_step_keeping_grads(step, tstate, tb, torch.Generator(), **FLAGS)
    assert float(tld["loss_max_atten"]) > 0
    _check_losses(jld, tld)
    got = to_jax(grads)
    assert JAX_PROJ in got and float(np.abs(got[JAX_PROJ]).max()) > 0
    _check_grads(_flat("params", jstate.opt_state[1]), got)
    _check_state(jstate, tstate, lr=LR)


def test_atten_stride_selective_remat_equals_the_plain_step(train_setup):
    """The instance decoder with the stride stays inside the os8 segment of
    ``selective`` remat: the step's losses and gradients bit-equal to the
    plain step's."""
    _, tb = train_batch(seed=1)
    results = []
    for remat in ("none", "selective"):
        tstate, step = _port_state(train_setup, remat)
        tld, grads = port_step_keeping_grads(step, tstate, tb, torch.Generator(), **FLAGS)
        results.append((tld, grads))
    (l0, g0), (l1, g1) = results
    assert set(l0) == set(l1) and set(g0) == set(g1)
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# -------------------------------------------------------------------- video
def test_video_window_through_the_feature_cache_matches_jax(mended):
    """The video model with lazy os2, the phase rung and stride 2: the port
    encodes frames 0-2, then frame 3, rolls its feature pack (which holds
    ``fea1`` and ``fea2``: the phase rung turns lazy os1 off, and lazy os2
    runs the dense branch) and decodes frames 1-3; JAX's forward
    on frames 1-3 gives the same outputs within 1e-5, every value the
    discrete thresholds read kept off them (``test_torch_video.py``)."""
    jcfg = flagged(video_cfg(), lazy_os2_shortcut=True, phase_rung=True, atten_stride=2)
    flat = random_flat(port_shapes(jcfg), seed=10)
    model = port_from_flat(port_cfg(jcfg), flat)
    jb, tb = window(0, n_f=4)
    with threshold_margins() as rec, torch.inference_mode():
        first = model.encode_frames({k: v[:, :3] for k, v in tb.items()})
        new = model.encode_frames({k: v[:, 3:] for k, v in tb.items()})
        rolled = {k: torch.cat([first[k][1:], new[k]]) for k in first}
        tout = model.decode_window(rolled)
    assert "fea2" in first and "fea1" in first and "inp" not in first
    assert_margins(rec, 1)
    jm = jax_build_model(jcfg.model)
    jout = jax.device_get(jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        jax_variables(flat), {k: v[:, 1:] for k, v in jb.items()}))
    np.testing.assert_array_equal(tout["detail_mask"].numpy(), np.asarray(jout["detail_mask"]))
    for k in ("diff_pred_forward", "diff_pred_backward"):
        np.testing.assert_array_equal(tout[k].numpy() > 0.5, np.asarray(jout[k]) > 0.5, k)
    for k in KEYS + ("temp_alpha",):
        close(tout[k].numpy(), jout[k], k)


def test_cli_evaluates_with_every_alternative(him_root, tmp_path):
    """``main --eval-only --device cpu`` on ``test_torch_engine.py``'s HIM set
    with the four flags as CLI overrides: it builds the model, evaluates
    every image and logs the metrics."""
    from maggie_tpu_torch import main
    flags = ["model.encoder_args.s2d_stem", "true", "model.encoder_args.lazy_os2_shortcut", "true",
             "model.decoder_args.phase_rung", "true", "model.decoder_args.atten_stride", "2"]
    main.main(["--config", CONFIG, "--eval-only", "--device", "cpu", "name", "alternatives",
               "output_dir", str(tmp_path), "test.log_iter", "1"]
              + _opts(him_root)[:-4] + MODEL_OPTS + flags)
    log = (tmp_path / "alternatives" / "test-log_rank0.log").read_text()
    assert "s2d_stem: true" in log and "atten_stride: 2" in log, log[:2000]
    assert re.search(r"MAD", log), log[-2000:]
