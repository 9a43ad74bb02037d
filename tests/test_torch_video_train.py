"""The port's video training (``MaGGIe_Temp`` in train mode) against the JAX
package's on the CPU.

A reduced video model (``tests/test_video_e2e.py::_video_cfg``'s: atten_dim
32, final_channel 32, 3 slots, one attention block, ``bi_fusion``) trains
one step on a clip of 3 frames at 64x64 (b * n_f * slots = 9 maps) from
identical variables, with JAX's ``make_train_step`` unchanged: its optimizer
is wrapped only to hand back the gradients it receives. The four
random-width dilations of a step get the same widths on both sides
(``test_torch_train.py``'s monkeypatch, 9 maps), and ``inst_spec_dropout``
is 0.

Tolerances are ``test_torch_train.py``'s (its docstring gives their
reasons): gradients before the clip 5e-2 relative L2 per tensor and over
all; parameters after the step within 2 lr + 1e-6, at most 2% beyond 1e-6;
BatchNorm statistics 2e-5 and spectral-norm u/v 1e-6 (the diff module's,
stepped 4 times in the step, 1e-5 as ROADMAP asks); loss terms rtol 1e-5,
except the terms that read the os8 alpha or the os8 features (the diff
module's input) and the sums they enter. On this batch those read up to
6.1e-5 (``loss_grad_os8``; 1.3e-4 on another batch), the others at most
1.0e-6, because the train-mode video network is ill-conditioned at random
weights: on the port alone, a 1e-7 relative change of the input frames
moves the os8 alpha by 9.4e-5 and ``loss_dtSSD_os8`` by 1.0e-5 (relative),
while XLA:CPU's f32 sums leave the JAX package's os8 alpha 7.0e-4 from the
port's; and the os8 loss weight thresholds that alpha at 1/255 and 254/255
(``loss_reweight_os8``), where 9 of its 36,864 pixels lie within 1e-5. So
those terms are held at ``OS8_LOSS_RTOL`` 5e-4.

Module by module, where nothing is that sensitive: ``loss_temporal_sparsity``
and its gradient at rtol 1e-5; the diff module's bidirectional fusion in
train mode (its 4 chained BatchNorm and spectral-norm steps, their state and
the parameter gradients through the chain) within 1e-5; the temporal sine
embedding within 1e-6 and the instance decoder with ``use_temp_pe`` within
``test_torch_modules.py``'s 1e-5.
"""

import copy
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as jnn
import torch

import maggie_tpu.models.layers as jlayers
import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.ops.morphology as tmorph
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu.models.decoder_video import ResShortCutInstMattSpconvTempDec as JaxVideoDec
from maggie_tpu.models.instance_decoder import InstanceMatteDecoder as JaxIMD
from maggie_tpu.models.position_encoding import temporal_position_embedding_sine as jax_pe
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.models import build_model, layers as tlayers
from maggie_tpu_torch.models.decoder_video import ResShortCutInstMattSpconvTempDec
from maggie_tpu_torch.models.instance_decoder import InstanceMatteDecoder
from maggie_tpu_torch.models.layers import end_sn_chains
from maggie_tpu_torch.models.position_encoding import temporal_position_embedding_sine
from maggie_tpu_torch.utils.convert_jax import _KeyMap, convert_jax, to_jax
from test_torch_harness import (jax_step_lock, jax_variables, one_torch_thread,  # noqa: F401
                                random_flat)
from test_torch_train import (FLAGS, _check_grads, _check_state, _flat,  # noqa: F401
                              _keeping_grads, port_step_keeping_grads)
from test_torch_video import video_cfg

LOSS_RTOL = 1e-5
OS8_LOSS_RTOL = 5e-4
DIFF_ATOL = 1e-5
N_F, HW, N_I = 3, 64, 3
LR = 1.5e-4 / 25   # the cosine schedule's first learning rate (warmup 1000, test_torch_train)


def train_video_cfg():
    cfg = video_cfg()
    cfg.model.decoder_args.inst_spec_dropout = 0.0
    cfg.train.optimizer.update(dict(name="adamw", lr=1.5e-4, betas=[0.9, 0.999],
                                    weight_decay=0.01))
    cfg.train.scheduler.update(dict(name="cosine", warmup_iters=1000))
    cfg.train.max_iter = 52000
    return cfg


def clip_batch(seed=0):
    """3 frames at 64x64: soft discs that move a few pixels a frame in slots
    0 and 1, slot 2 empty; masks the alphas above 0.5; the transition GT
    ones on frame 0 and the pixels that changed by more than 0.02 after it."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    alpha = np.zeros((1, N_F, N_I, HW, HW), np.float32)
    for j in range(N_I - 1):
        cy, cx = rs.randint(16, 48, 2)
        for t in range(N_F):
            alpha[0, t, j] = np.clip((16 - np.hypot(yy - cy - t, xx - cx - 2 * t)) / 5, 0, 1)
    changed = (np.abs(alpha[:, 1:] - alpha[:, :-1]) > 0.02).any(2, keepdims=True)
    trans = np.concatenate([np.ones((1, 1, N_I, HW, HW), bool), changed.repeat(N_I, 2)], 1)
    batch = {"image": rs.rand(1, N_F, HW, HW, 3).astype(np.float32),
             "mask": (alpha > 0.5).astype(np.float32), "alpha": alpha,
             "transition": trans.astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# the widths of a step's four random-width dilations (fusion k=27 and k=15,
# the GT weights k=30 and k=15), one per map
_WIDTHS = [np.random.RandomState(k).randint(1, k, N_F * N_I) for k in (27, 15, 30, 15)]
_PORT_DILATE = tmorph.dilate_ellipse_random


def _jax_dilate(calls):
    def dilate(binary, k_size, rng):
        widths = _WIDTHS[next(calls) % 4]
        n = int(np.prod(binary.shape[:-2]))
        h, w = binary.shape[-2:]
        buf = jmorph._odd_buf(k_size - 1)
        bank = np.stack([jmorph._embedded_offset_kernel(wd, buf) for wd in range(1, k_size)], 0)
        y = jax.lax.conv_general_dilated(
            binary.reshape((1, n, h, w)).astype(jnp.float32), jnp.asarray(bank[widths - 1])[:, None],
            window_strides=(1, 1), padding=[(buf // 2, buf // 2)] * 2,
            dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=n)
        return (y > 0.0).reshape(binary.shape).astype(binary.dtype)
    return dilate


def _port_dilate(calls):
    def dilate(binary, k_size, generator=None):
        return _PORT_DILATE(binary, k_size, widths=torch.from_numpy(_WIDTHS[next(calls) % 4]))
    return dilate


@pytest.fixture(scope="module")
def setup():
    cfg = train_video_cfg()
    pcfg = ConfigNode(cfg.to_dict())
    model = build_model(pcfg.model, device="cpu")
    shapes = {k: v.shape for k, v in to_jax(model.state_dict()).items()}
    flat = random_flat(dict(sorted(shapes.items())), seed=10)
    variables = jax_variables(flat)
    model.load_state_dict(convert_jax(flat, model))
    jm = jax_build_model(cfg.model)
    tx = _keeping_grads(jax_build_optimizer(cfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           opt_state=jax.jit(tx.init)(variables["params"]),
                           batch_stats=variables["batch_stats"], spectral=variables["spectral"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random", _jax_dilate(itertools.count()))
        mp.setattr(tmorph, "dilate_ellipse_random", _port_dilate(itertools.count()))
        yield dict(jm=jm, variables=variables, jstate=jstate, pcfg=pcfg, model=model,
                   sd=copy.deepcopy(model.state_dict()), step=jax_make_train_step(jm, tx))


def _os8_term(key: str) -> bool:
    """The terms that read the os8 alpha or the os8 features (the diff
    module's input), and the sums they enter."""
    return key.endswith("_os8") or key.startswith("loss_temp") or key in (
        "loss_rec", "loss_lap", "loss_grad", "loss_dtSSD", "total")


def test_video_train_step_matches_jax(setup):
    """One step from identical variables: every loss term (the temporal ones
    included), the gradients before the clip, and the state after."""
    jb, tb = clip_batch()
    with jax_step_lock("video"):   # test_torch_remat.py holds the port to the same step
        jstate, jld = setup["step"](setup["jstate"], jb, jax.random.PRNGKey(1), **FLAGS)
    model = setup["model"]
    model.load_state_dict(setup["sd"])
    model.train()
    opt, schedule = build_optimizer(setup["pcfg"], model.parameters())
    state = TrainState(model, opt)
    tld, grads = port_step_keeping_grads(make_train_step(model, opt, schedule), state, tb,
                                         torch.Generator(), **FLAGS)

    temporal = {"loss_temp", "loss_temp_bce", "loss_temp_dtssd"}
    assert set(tld) == set(jld) and temporal <= set(tld), sorted(set(tld) ^ set(jld))
    for k, v in jld.items():
        tol = OS8_LOSS_RTOL if _os8_term(k) else LOSS_RTOL
        np.testing.assert_allclose(float(tld[k]), float(v), rtol=tol, err_msg=k)
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(grads))
    assert state.step == int(jstate.step) == 1
    _check_state(jstate, state, lr=LR)
    # the diff module's chained BatchNorm statistics and spectral norms
    for name in ("batch_stats", "spectral"):
        want = {k: v for k, v in _flat(name, getattr(jstate, name)).items() if "diff_module" in k}
        got = to_jax(getattr(state, name)())
        assert len(want) == 4
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=DIFF_ATOL, err_msg=k)


def test_loss_temporal_sparsity_matches_jax():
    """BCE + dtSSD of random change-map logits against a 0/1 transition GT,
    b 2 x 4 frames: every term and the logits' gradients, rtol 1e-5."""
    rs = np.random.RandomState(3)
    fwd, bwd = (rs.randn(2, 4, 1, 24, 20).astype(np.float32) * 3 for _ in range(2))
    fwd[:, 0] = 0
    bwd[:, -1] = 0
    gt = (rs.rand(8, 3, 24, 20) > 0.6).astype(np.float32)

    def jloss(f, b):
        return JaxVideoDec.loss_temporal_sparsity(None, f, b, jnp.asarray(gt), 2)
    want = jloss(jnp.asarray(fwd), jnp.asarray(bwd))
    jgrad = jax.grad(lambda f, b: jloss(f, b)["loss_temp"], argnums=(0, 1))(
        jnp.asarray(fwd), jnp.asarray(bwd))
    tf, tb = (torch.from_numpy(a).requires_grad_() for a in (fwd, bwd))
    got = ResShortCutInstMattSpconvTempDec.loss_temporal_sparsity(tf, tb, torch.from_numpy(gt), 2)
    assert set(got) == set(want) == {"loss_temp", "loss_temp_bce", "loss_temp_dtssd"}
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    got["loss_temp"].backward()
    for t, g in zip((tf, tb), jgrad):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * float(np.abs(np.asarray(g)).max()))


def test_diff_module_chain_matches_jax(setup):
    """``bidirectional_fusion`` in train mode over 4 frames (6 diff-module
    calls, forward pairs first): the diff logits and fused alphas, the
    BatchNorm statistics and u/v after the chain, and the gradients of a
    random cotangent with respect to the diff module's parameters and the
    alphas, which flow through the chained spectral-norm steps; 1e-5. The
    stored u of the two SN convs is a random unit vector, far from the
    singular vector, so that each call's power step moves u and v and the
    state after the chain depends on every call reading the u the call
    before wrote. (The chain's part of the gradient is small here: each SN
    conv feeds a train-mode BatchNorm, which takes sigma's scale out again;
    cutting the chain moves the weight gradients by 1.9e-6 of their
    largest.)"""
    rs = np.random.RandomState(4)
    feat = rs.randn(1, 4, 8, 8, 32).astype(np.float32)          # (b, n_f, h8, w8, c)
    preds = rs.rand(1, 4, 3, 32, 32).astype(np.float32)
    v = setup["variables"]
    dec_params = v["params"]["decoder_mod"]
    u0 = {c: rs.randn(n).astype(np.float32) for c, n in (("conv1", 64), ("conv2", 32))}
    u0 = {c: u / np.linalg.norm(u) for c, u in u0.items()}
    sn = {**v["spectral"]["decoder_mod"]["diff_module"]}
    sn = {c: {**sn[c], "u": jnp.asarray(u0[c])} if c in u0 else sn[c] for c in sn}
    spectral = {**v["spectral"], "decoder_mod": {**v["spectral"]["decoder_mod"],
                                                  "diff_module": sn}}

    def jfn(params, p):
        out, mut = setup["jm"].apply(
            {"params": {**v["params"], "decoder_mod": {**dec_params, "diff_module": params}},
             "batch_stats": v["batch_stats"], "spectral": spectral},
            jnp.asarray(feat), p, True, True,
            method=lambda m, f, pp, t, u: m.decoder.bidirectional_fusion(f, pp, t, u),
            mutable=["batch_stats", "spectral"])
        return out, mut
    (jf, jb_, jfused), mut = jfn(dec_params["diff_module"], jnp.asarray(preds))
    cts = [rs.randn(*np.shape(x)).astype(np.float32) for x in (jf, jb_, jfused)]
    jg = jax.grad(lambda prm, p: sum((o * c).sum() for o, c in zip(jfn(prm, p)[0], cts)),
                  argnums=(0, 1))(dec_params["diff_module"], jnp.asarray(preds))

    model = setup["model"]
    model.load_state_dict(setup["sd"])
    model.train()
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        for i, c in ((0, "conv1"), (3, "conv2")):
            model.decoder.diff_module[i].module.weight_u.copy_(torch.from_numpy(u0[c]))
    tp = torch.from_numpy(preds).requires_grad_()
    outs = model.decoder.bidirectional_fusion(
        torch.from_numpy(feat).permute(0, 1, 4, 2, 3).contiguous(), tp)
    end_sn_chains(model)
    for o, j in zip(outs, (jf, jb_, jfused)):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), rtol=0, atol=DIFF_ATOL)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)).backward()
    for name in ("batch_stats", "spectral"):
        want = {k: x for k, x in _flat(name, mut[name]).items() if "diff_module" in k}
        got = to_jax({k: b for k, b in model.named_buffers()})
        for k, x in want.items():
            np.testing.assert_allclose(got[k], x, rtol=0, atol=DIFF_ATOL, err_msg=k)
    want = _flat("params/decoder_mod/diff_module", jg[0])
    got = to_jax({k: p.grad for k, p in model.named_parameters() if "diff_module" in k})
    scale = max(float(np.abs(x).max()) for x in want.values())
    for k, x in want.items():
        np.testing.assert_allclose(got[k], x, rtol=0, atol=DIFF_ATOL * scale, err_msg=k)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg[1]), rtol=0, atol=DIFF_ATOL)


class _SNThrice(jnn.Module):
    """One JAX spectral-norm conv called on three inputs in one train forward."""
    transpose: bool

    @jnn.compact
    def __call__(self, xs):
        conv = jlayers.SNConvTranspose(8) if self.transpose else jlayers.SNConv(8)
        return tuple(conv(x, update_sn=True) for x in xs)


@pytest.mark.parametrize("transpose", [False, True])
def test_sn_chain_gradient_matches_jax(transpose):
    """The gradient through a chain of spectral-norm power steps, alone: one
    SN conv (or transposed conv) with no BatchNorm after it, called on three
    inputs in one train forward from a random unit u, far from the singular
    vector. Each call steps from the u the call before wrote; the outputs,
    the u/v after the chain and the gradients of a random cotangent with
    respect to the weight and the inputs equal the JAX package's within
    ``DIFF_ATOL`` of their largest. The same forward with the chain cut
    after each call (``end_sn_chains``: each step starts from a constant u)
    gives the same outputs, but its weight gradient differs from the chained
    one by more than 100 times that tolerance (1.6e-2 of the largest for the
    conv, 4.0e-2 for the transposed conv, against 2.3e-7 between the port
    and the JAX package), so the comparison sees the chain's part of the
    gradient, and it fails when each call steps from the stored u."""
    rs = np.random.RandomState(11)
    shape = (1, 5, 6, 8)
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(3)]
    jmod = _SNThrice(transpose)
    v = jmod.init(jax.random.PRNGKey(2), [jnp.asarray(x) for x in xs])
    name = "SNConvTranspose_0" if transpose else "SNConv_0"
    u0 = rs.randn(8).astype(np.float32)
    u0 /= np.linalg.norm(u0)
    spectral = {name: {**v["spectral"][name], "u": jnp.asarray(u0)}}

    def jfn(params, ins):
        return jmod.apply({"params": params, "spectral": spectral}, ins, mutable=["spectral"])
    jouts, mut = jfn(v["params"], [jnp.asarray(x) for x in xs])
    cts = [rs.randn(*np.shape(o)).astype(np.float32) for o in jouts]
    jg = jax.grad(lambda prm, ins: sum((o * c).sum() for o, c in zip(jfn(prm, ins)[0], cts)),
                  argnums=(0, 1))(v["params"], [jnp.asarray(x) for x in xs])

    w = torch.from_numpy(np.array(v["params"][name]["weight_bar"]))
    mod = (tlayers.SNConvTranspose(8, 8) if transpose else tlayers.SNConv(8, 8)).train()
    mod.load_state_dict({"module.weight_bar": w.permute(*((2, 3, 0, 1) if transpose
                                                          else (3, 2, 0, 1))),
                         "module.weight_u": torch.from_numpy(u0),
                         "module.weight_v": torch.from_numpy(np.array(v["spectral"][name]["v"]))})

    def port(cut: bool):
        m = copy.deepcopy(mod)
        ins = [torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_() for x in xs]
        outs = []
        for x in ins:
            outs.append(m(x))
            if cut:
                end_sn_chains(m)
        end_sn_chains(m)
        sum((o * torch.from_numpy(c).permute(0, 3, 1, 2)).sum() for o, c in zip(outs, cts)).backward()
        return m, outs, ins
    m, outs, ins = port(cut=False)
    for o, j in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                   rtol=0, atol=DIFF_ATOL)
    np.testing.assert_allclose(m.module.weight_u.numpy(), np.asarray(mut["spectral"][name]["u"]),
                               rtol=0, atol=DIFF_ATOL)
    np.testing.assert_allclose(m.module.weight_v.numpy(), np.asarray(mut["spectral"][name]["v"]),
                               rtol=0, atol=DIFF_ATOL)
    want = np.asarray(jg[0][name]["weight_bar"]).transpose((2, 3, 0, 1) if transpose
                                                           else (3, 2, 0, 1))
    scale = float(np.abs(want).max())
    got = m.module.weight_bar.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DIFF_ATOL * scale)
    for x, j in zip(ins, jg[1]):
        np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j), rtol=0,
                                   atol=DIFF_ATOL * float(np.abs(np.asarray(j)).max()))
    m_cut, outs_cut, _ = port(cut=True)
    for o, oc in zip(outs, outs_cut):
        torch.testing.assert_close(oc, o, rtol=0, atol=0)
    chain_part = float(np.abs(m_cut.module.weight_bar.grad.numpy() - got).max())
    assert chain_part > 100 * DIFF_ATOL * scale, (chain_part, scale)


@pytest.mark.parametrize("shape", [(2, 3, 1, 1, 32), (1, 4, 5, 7, 128)])
def test_temporal_position_embedding_matches_jax(shape):
    b, n_f, h, w, c = shape
    np.testing.assert_allclose(temporal_position_embedding_sine(b, n_f, h, w, c).numpy(),
                               np.asarray(jax_pe(b, n_f, h, w, c)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_instance_decoder_temp_pe_matches_jax(train):
    """The instance decoder with ``use_temp_pe`` (no config reaches it), built
    directly: 32 channels (8 of them temporal), 3 frames, the memory-free
    eval and the train forward with GT attention supervision; logits,
    features, tokens and the attention loss within 1e-5, as
    ``test_torch_modules.py`` holds the instance decoder (its logits reach 8,
    and differ by up to 8.1e-6, the sums' rounding)."""
    rs = np.random.RandomState(5)
    kw = dict(input_dim=16, attention_dim=32, n_block=1, n_head=1, output_dim=16, max_inst=3)
    feat = rs.randn(3, 8, 8, 16).astype(np.float32)
    mask = (rs.rand(1, 3, 3, 32, 32) > 0.6).astype(np.float32)
    mask[0, :, 2] = 0
    gt = (rs.rand(1, 3, 3, 32, 32) > 0.5).astype(np.float32)
    jmod = JaxIMD(use_temp_pe=True, use_id_pe=True, **kw)
    tree = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(feat),
                                            jnp.asarray(mask), False))
    from flax.traverse_util import flatten_dict
    flat = random_flat({"/".join(k): x.shape for k, x in flatten_dict(tree).items()}, seed=6)
    (jout, _) = jmod.apply(jax_variables(flat), jnp.asarray(feat), jnp.asarray(mask), False,
                           jnp.asarray(gt), train=train, mutable=["batch_stats"])
    km = _KeyMap()
    km.instance_matte_decoder("m", "m", 1)
    sd = {}
    for tkey, jkey, fn in km.entries:
        jkey = jkey.replace("/m/", "/")
        if jkey in flat:
            sd[tkey[2:]] = torch.from_numpy(np.ascontiguousarray(
                flat[jkey] if fn is None else np.transpose(flat[jkey], fn)))
    port = InstanceMatteDecoder(use_temp_pe=True, **kw)
    assert port.id_embedding.weight.shape == (4, 24)
    port.load_state_dict(sd, strict=False)
    port.train(train)
    with torch.no_grad():
        tout = port(torch.from_numpy(feat).permute(0, 3, 1, 2), torch.from_numpy(mask),
                    torch.from_numpy(gt))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout[1].permute(0, 2, 3, 1).numpy(), np.asarray(jout[1]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(tout[3]), float(jout[3]), rtol=0, atol=1e-5)
    assert (float(tout[3]) > 0) == train

