"""The port's training step against the JAX package's, on the CPU.

A reduced flagship model (atten_dim 32, final_channel 32; the encoder at its
published depth) trains on a 128x128 frame with 3 instances, padded to the 10
slots as the flagship does, on identical variables (``convert_jax``). The
four random-width dilations of a step (fusion k=27 and k=15, the GT weights
k=30 and k=15) are fed the same widths on both sides by monkeypatching
``dilate_ellipse_random`` in this file only, and ``inst_spec_dropout`` is 0, so
that the two steps compute the same function. The JAX step is compiled once
per flag combination for the whole module.

Why the whole-step tolerances are looser than the modules': XLA:CPU sums an
f32 reduction in one running accumulator, the port (oneDNN, ATen) in
blocks. On one of this model's masked BatchNorms, fed identical inputs,
the JAX package's layer is 6.6e-5 off a float64 evaluation and the port's
1.1e-6. This random-weight network then amplifies such differences through
~70 layers of batch statistics: the port against itself, on 1 and on 8
threads, moves a tensor's gradient by up to 8e-3 (relative L2); the JAX
package differs from the port by up to 3.0e-2 (2.1e-2 over all parameters).
So:
- loss terms: rtol 1e-5 (measured 2e-7);
- gradients before clipping: relative L2 <= 5e-2 per tensor (tensors whose
  gradient norm is under 1e-6 of the largest are held to the largest's
  scale) and over all parameters;
- parameters after one AdamW step (lr 6e-6, the cosine schedule's first):
  the first update is lr * g / (|g| + eps), about lr whatever |g|, so a
  gradient element near 0 whose sign differs moves by up to 2 lr: every
  element within 2 lr + 1e-6 and at most 2% beyond 1e-6 (measured 0.47%);
- BatchNorm running statistics 2e-5 (measured 9.8e-6, the same f32 sums);
  spectral-norm u/v 1e-6 (measured 1.2e-7).
Where the reference sums accurately, on each train-mode module's VJP at
random inputs, the port holds 1e-4 of the largest gradient
(``test_module_vjp_matches_jax``; measured about 1e-5), and the optimizer on
identical gradients holds 1e-6 relative.
"""

import copy
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax.traverse_util import flatten_dict

import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.ops.morphology as tmorph
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu.models import layers as jlayers
from maggie_tpu.models import sparse_layers as jsparse
from maggie_tpu.ops.resize import resize_any_shape as jax_resize_any_shape
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer, clip_by_global_norm_
from maggie_tpu_torch.engine.train_step import TrainState, compute_grads, make_train_step
from maggie_tpu_torch.models import layers as tlayers
from maggie_tpu_torch.models import sparse_layers as tsparse
from maggie_tpu_torch.ops.resize import resize_any_shape
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.utils.convert_jax import convert_jax, flatten_collections, to_jax
from test_torch_harness import jax_cfg, jax_shapes, jax_variables, random_flat

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 5e-2
PARAM_ATOL = 1e-6
PARAM_FAR_SHARE = 0.02
STATS_ATOL = 2e-5
SN_ATOL = 1e-6
MODULE_GRAD_REL = 1e-4
HW, N_INST = 128, 3
FLAGS = dict(use_mask_atten=False, use_gt_guidance=False, use_prm_weights=True,
             atten_loss_enabled=True)


def train_cfg():
    """The flagship reduced to atten 32 / final 32, with bench_train's optimizer."""
    cfg = jax_cfg()
    cfg.model.decoder_args.inst_spec_dropout = 0.0
    cfg.train.optimizer.update(dict(name="adamw", lr=1.5e-4, betas=[0.9, 0.999],
                                    weight_decay=0.01))
    cfg.train.scheduler.update(dict(name="cosine", warmup_iters=1000))
    cfg.train.max_iter = 52000
    return cfg


def train_batch(seed=0):
    """bench_train's recipe at 128x128 (frame uniform, masks > 0.8 at 1/8),
    with each instance's alpha a uniform square of half the frame, so that the
    GT masks (alpha > 0) supervise the attention; transitions > 0.8 inside."""
    rs = np.random.RandomState(seed)
    alpha = np.zeros((1, 1, N_INST, HW, HW), np.float32)
    for j in range(N_INST):
        y0, x0 = rs.randint(0, HW // 2, 2)
        alpha[0, 0, j, y0:y0 + HW // 2, x0:x0 + HW // 2] = rs.rand(HW // 2, HW // 2)
    batch = {"image": rs.rand(1, 1, HW, HW, 3).astype(np.float32),
             "mask": (rs.rand(1, 1, N_INST, HW // 8, HW // 8) > 0.8).astype(np.float32),
             "alpha": alpha,
             "transition": ((rs.rand(*alpha.shape) > 0.8) & (alpha > 0)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# The widths of the four random-width dilations of one step, in call order
# (fusion k=27, k=15; GT weights k=30, k=15), one per map (10 slots).
_WIDTHS = [np.random.RandomState(k).randint(1, k, 10) for k in (27, 15, 30, 15)]
_PORT_DILATE = tmorph.dilate_ellipse_random   # before the fixture patches it


def _jax_dilate_with_widths(calls):
    """The JAX package's ``dilate_ellipse_random`` with the widths of the next
    call in order instead of its draw (its own body, ``morphology.py:154-170``)."""
    def dilate(binary, k_size, rng):
        widths = _WIDTHS[next(calls) % 4]
        assert widths.max() < k_size
        lead = binary.shape[:-2]
        n = int(np.prod(lead))
        h, w = binary.shape[-2:]
        buf = jmorph._odd_buf(k_size - 1)
        bank = np.stack([jmorph._embedded_offset_kernel(wd, buf) for wd in range(1, k_size)], 0)
        kernels = jnp.asarray(bank[widths - 1])
        y = jax.lax.conv_general_dilated(
            binary.reshape((1, n, h, w)).astype(jnp.float32), kernels[:, None],
            window_strides=(1, 1), padding=[(buf // 2, buf // 2)] * 2,
            dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=n)
        return (y > 0.0).reshape(binary.shape).astype(binary.dtype)
    return dilate


def _port_dilate_with_widths(calls):
    orig = tmorph.dilate_ellipse_random

    def dilate(binary, k_size, generator=None):
        return orig(binary, k_size, widths=torch.from_numpy(_WIDTHS[next(calls) % 4]))
    return dilate


@pytest.fixture(scope="module")
def setup():
    jcfg = train_cfg()
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed=8)
    variables = jax_variables(flat)
    tx, _ = jax_build_optimizer(jcfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           opt_state=tx.init(variables["params"]),
                           batch_stats=variables["batch_stats"], spectral=variables["spectral"])
    pcfg = ConfigNode(jcfg.to_dict())
    # the JAX train state's collections into the unfolded port model
    model = port_build_model(pcfg.model, device="cpu")
    model.load_state_dict(convert_jax(flatten_collections(
        params=jstate.params, batch_stats=jstate.batch_stats, spectral=jstate.spectral), model))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random", _jax_dilate_with_widths(itertools.count()))
        mp.setattr(tmorph, "dilate_ellipse_random", _port_dilate_with_widths(itertools.count()))
        yield dict(jm=jm, tx=tx, jstate=jstate, step=jax_make_train_step(jm, tx),
                   variables=variables, pcfg=pcfg, sd=copy.deepcopy(model.state_dict()),
                   model=model)


def _port_state(setup):
    model = setup["model"]
    model.load_state_dict(setup["sd"])
    model.train()
    opt, schedule = build_optimizer(setup["pcfg"], model.parameters())
    return TrainState(model, opt), make_train_step(model, opt, schedule)


def _flat(prefix, tree):
    return {f"{prefix}/" + "/".join(k): np.asarray(v) for k, v in flatten_dict(tree).items()}


def _l2(a):
    return float(np.sqrt((np.asarray(a, np.float64) ** 2).sum()))


def _check_losses(jld, tld):
    assert set(tld) == set(jld), (sorted(tld), sorted(jld))
    for k, v in jld.items():
        np.testing.assert_allclose(float(tld[k]), float(v), rtol=LOSS_RTOL, err_msg=k)


def _check_grads(want, got):
    assert set(got) == set(want)
    top = max(_l2(g) for g in want.values())
    for k, g in want.items():
        scale = max(_l2(g), 1e-6 * top)
        assert _l2(got[k] - g) <= GRAD_REL_L2 * scale, (k, _l2(got[k] - g), _l2(g))
    total = np.sqrt(sum(_l2(got[k] - g) ** 2 for k, g in want.items()))
    assert total <= GRAD_REL_L2 * np.sqrt(sum(_l2(g) ** 2 for g in want.values()))


def _check_state(jstate, tstate, lr):
    want, got = _flat("params", jstate.params), to_jax(tstate.params())
    assert set(got) == set(want)
    d = {k: np.abs(got[k] - w) for k, w in want.items()}
    assert max(float(v.max()) for v in d.values()) <= 2 * lr + PARAM_ATOL
    far = sum(int((v > PARAM_ATOL).sum()) for v in d.values())
    assert far <= PARAM_FAR_SHARE * sum(v.size for v in d.values()), far
    for name, tol in (("batch_stats", STATS_ATOL), ("spectral", SN_ATOL)):
        want = _flat(name, getattr(jstate, name))
        got = to_jax(getattr(tstate, name)())
        assert set(got) == set(want), name
        worst = max((float(np.abs(got[k] - w).max()), k) for k, w in want.items())
        assert worst[0] <= tol, (name, worst)


def _jax_grads(setup, batch):
    """The JAX step's loss and gradients (``train_step.py:82-103``), jitted."""
    jm, state = setup["jm"], setup["jstate"]

    @jax.jit
    def grads(state, batch, rng):
        k_unknown, k_dropout = jax.random.split(jax.random.fold_in(rng, state.step))

        def loss_fn(params):
            (_, ld), _ = jm.apply(
                {"params": params, "batch_stats": state.batch_stats, "spectral": state.spectral},
                batch, train=True, update_sn=True, **FLAGS,
                rngs={"unknown": k_unknown, "dropout": k_dropout},
                mutable=["batch_stats", "spectral"])
            return ld["total"], ld
        (_, ld), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return ld, g
    return grads(state, batch, jax.random.PRNGKey(1))


def test_train_step_matches_jax(setup):
    """Default flags (bench_train's): loss terms, gradients before clipping,
    and the state after one step."""
    jb, tb = train_batch()
    jld, jgrads = _jax_grads(setup, jb)
    tstate, step = _port_state(setup)
    grads_model = copy.deepcopy(tstate.model)
    _check_losses(jld, compute_grads(grads_model, tb, torch.Generator(), **FLAGS))
    _check_grads(_flat("params", jgrads),
                 to_jax({k: p.grad for k, p in grads_model.named_parameters()}))

    jstate, jld2 = setup["step"](setup["jstate"], jb, jax.random.PRNGKey(1), **FLAGS)
    tld2 = step(tstate, tb, torch.Generator())
    _check_losses(jld2, tld2)
    assert tstate.step == int(jstate.step) == 1
    _check_state(jstate, tstate, lr=1.5e-4 / 25)


@pytest.mark.parametrize("flags", [dict(use_gt_guidance=True), dict(use_prm_weights=False)])
def test_train_step_flags_match_jax(setup, flags):
    """GT guidance of the uncertainty map and the detail mask as the loss
    weights: loss terms and the state after one step."""
    flags = {**FLAGS, **flags}
    jb, tb = train_batch(seed=1)
    jstate, jld = setup["step"](setup["jstate"], jb, jax.random.PRNGKey(1), **flags)
    tstate, step = _port_state(setup)
    tld = step(tstate, tb, torch.Generator(), **flags)
    _check_losses(jld, tld)
    _check_state(jstate, tstate, lr=1.5e-4 / 25)


# ------------------------------------------------ train-mode module gradients
def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous()


def _ladder_inputs(rs):
    roi = np.zeros((1, 10, HW, HW), np.float32)
    for j in range(3):
        y0, x0 = rs.randint(0, 64, 2)
        roi[0, j, y0:y0 + 50, x0:x0 + 40] = 1
    ins = {"o8": rs.randn(1, 16, 16, 32), "q": rs.randn(1, 10, 32), "f1": rs.randn(1, 128, 128, 32),
           "f2": rs.randn(1, 64, 64, 32), "f3": rs.randn(1, 32, 32, 64)}
    return roi, {k: v.astype(np.float32) for k, v in ins.items()}


def _module_case(name, rs):
    """(JAX method of the model, port function, inputs (NHWC or plain),
    whether the port's output is NCHW where the JAX one is NHWC) of one
    train-mode module."""
    if name == "aspp":
        return (lambda m, x: m.aspp(x, train=True), lambda tm, x: tm.aspp(x),
                {"x": rs.randn(1, 4, 4, 512).astype(np.float32)}, True)
    if name.startswith("decoder_layer"):   # SN power steps, transposed convs, BatchNorms
        layer = name[len("decoder_"):]
        c, hw = (512, 4) if layer == "layer1" else (256, 8)
        return (lambda m, x: getattr(m.decoder, layer)(x, True, True),
                lambda tm, x: getattr(tm.decoder, layer)(x),
                {"x": rs.randn(1, hw, hw, c).astype(np.float32)}, True)
    if name.startswith("attention"):  # the os8 instance decoder with its attention loss
        part = int(name[-1])
        masks = np.zeros((1, 1, 10, HW, HW), np.float32)
        masks[0, 0, 0, 8:60, 10:70] = 1.0
        masks[0, 0, 1] = rs.rand(HW, HW) > 0.8
        gt = np.zeros_like(masks)
        gt[0, 0, 0, 4:50, 20:80] = 1.0
        gt[0, 0, 1, 60:120, 0:70] = 1.0
        return (lambda m, z: m.decoder.refine_OS8(z, jnp.asarray(masks), use_mask_atten=False,
                                                  gt_mask=jnp.asarray(gt), train=True)[part],
                lambda tm, z: tm.decoder.refine_OS8(z, torch.from_numpy(masks),
                                                    torch.from_numpy(gt), False)[part],
                {"z": rs.randn(1, 16, 16, 128).astype(np.float32)}, part == 1)
    part = 0 if name == "ladder_os4" else 1
    roi, ins = _ladder_inputs(rs)
    return (lambda m, o8, q, f1, f2, f3: m.decoder.predict_details_block(
                o8, jnp.asarray(roi), q, f1, f2, f3, True)[part],
            lambda tm, o8, q, f1, f2, f3: tm.decoder.predict_details_block_train(
                o8, torch.from_numpy(roi), q, f1, f2, f3, torch.Generator())[part],
            ins, False)


@pytest.mark.parametrize("name", ["aspp", "decoder_layer1", "decoder_layer2", "attention_logits0",
                                  "attention_features1", "attention_queries2",
                                  "attention_loss3", "ladder_os4", "ladder_os1"])
def test_module_vjp_matches_jax(setup, name):
    """One train-mode module's outputs and VJP (a random cotangent) against
    ``jax.vjp`` of the JAX module at random inputs: the input and parameter
    gradients within 1e-4 of the largest gradient of their kind. Each module
    on its own: chained, even os32 -> os8 (layer1 then layer2, batch
    statistics over 16 and 64 sites) moves the port's own input gradient by
    0.7% for a 1e-7 relative change of its input."""
    rs = np.random.RandomState(0)
    jfn, tfn, ins, nchw_out = _module_case(name, rs)
    v = setup["variables"]

    def f(params, *args):
        out, _ = setup["jm"].apply(
            {"params": params, "batch_stats": v["batch_stats"], "spectral": v["spectral"]},
            *args, method=jfn, mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return out
    args = [jnp.asarray(a) for a in ins.values()]
    y = jax.jit(f)(v["params"], *args)
    ct = np.asarray(rs.randn(*np.shape(y)), np.float32)
    if name.startswith("ladder"):
        ct = ct * (np.asarray(y) > -90)          # no cotangent on the -99 sentinel
    jgp, *jgx = jax.jit(lambda p, c, *a: jax.vjp(f, p, *a)[1](c))(v["params"], jnp.asarray(ct),
                                                                  *args)

    _, step = _port_state(setup)
    model = setup["model"]
    model.zero_grad(set_to_none=True)
    tin = [(_nchw(a) if a.ndim == 4 else torch.from_numpy(a)).requires_grad_()
           for a in ins.values()]
    ty = tfn(model, *tin)
    nhwc = (lambda t: t.permute(0, 2, 3, 1)) if nchw_out else (lambda t: t)
    np.testing.assert_allclose(nhwc(ty.detach()).numpy(), np.asarray(y), rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(np.asarray(y)).max())))
    (nhwc(ty) * torch.from_numpy(ct)).sum().backward()
    for t, g in zip(tin, jgx):
        grad = torch.zeros_like(t) if t.grad is None else t.grad   # os4 reads no fea1, fea2
        got = grad.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else grad.numpy()
        scale = float(np.abs(np.asarray(g)).max())
        assert float(np.abs(got - np.asarray(g)).max()) <= MODULE_GRAD_REL * max(scale, 1e-30)
    want = _flat("params", jgp)
    got = to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad
                  for k, p in model.named_parameters()})
    got = {k: v for k, v in got.items() if k in want}   # the JAX module's own params
    scale = max(float(np.abs(v).max()) for v in want.values())
    assert scale > 0, "no parameter gradient"
    worst = max((float(np.abs(got[k] - want[k]).max()), k) for k in want)
    assert worst[0] <= MODULE_GRAD_REL * scale, (worst, scale)


# ------------------------------------------------ train-mode layers and ops
def test_sn_power_step_matches_jax():
    """One train-mode spectral-norm power step of an SN conv: the stored u and
    v it writes back and the normalized conv's output (1e-6), and the weight
    gradient through the step (1e-5 of its largest element)."""
    rs = np.random.RandomState(2)
    jmod = jlayers.SNConv(8, (3, 3), (1, 1), (1, 1))
    x = rs.randn(2, 10, 12, 5).astype(np.float32)
    w = (rs.randn(3, 3, 5, 8) * 0.3).astype(np.float32)
    u0 = rs.randn(8).astype(np.float32)
    v0 = rs.randn(45).astype(np.float32)
    u0, v0 = u0 / np.linalg.norm(u0), v0 / np.linalg.norm(v0)

    def f(wb):
        y, st = jmod.apply({"params": {"weight_bar": wb}, "spectral": {"u": u0, "v": v0}},
                           jnp.asarray(x), update_sn=True, mutable=["spectral"])
        return y, st["spectral"]
    y, st = f(jnp.asarray(w))
    ct = rs.randn(*y.shape).astype(np.float32)
    jgw = jax.grad(lambda wb: (f(wb)[0] * ct).sum())(jnp.asarray(w))

    tmod = tlayers.SNConv(5, 8, 3, 1, 1)
    tmod.load_state_dict({"module.weight_bar": torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
                          "module.weight_u": torch.from_numpy(u0),
                          "module.weight_v": torch.from_numpy(v0)})
    tmod.train()
    ty = tmod(_nchw(x))
    np.testing.assert_allclose(tmod.module.weight_u.numpy(), np.asarray(st["u"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tmod.module.weight_v.numpy(), np.asarray(st["v"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(np.asarray(y)).max())))
    (ty * _nchw(ct)).sum().backward()
    got = np.transpose(tmod.module.weight_bar.grad.numpy(), (2, 3, 1, 0))
    np.testing.assert_allclose(got, np.asarray(jgw), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jgw)).max()))


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_matches_jax(masked):
    """Train-mode BatchNorm (flax's: biased batch variance into the running
    estimate) and masked BatchNorm with a statistics mask (unbiased running
    variance): outputs and running statistics after one forward, 1e-5."""
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 9, 11, 6) * 2 + 0.5).astype(np.float32)
    scale, bias = rs.uniform(0.5, 1.5, 6).astype(np.float32), rs.uniform(-.2, .2, 6).astype(np.float32)
    mean0, var0 = rs.uniform(-.3, .3, 6).astype(np.float32), rs.uniform(.5, 1.5, 6).astype(np.float32)
    if masked:
        mask = (rs.rand(3, 9, 11, 1) > 0.4).astype(np.float32)
        stats = mask * (rs.rand(3, 9, 11, 1) > 0.3)
        jmod = jsparse.MaskedBatchNorm()
        jv = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
        y, st = jmod.apply(jv, jnp.asarray(x), jnp.asarray(mask), True, jnp.asarray(stats),
                           mutable=["batch_stats"])
        st = st["batch_stats"]
        tmod = tsparse.MaskedBatchNorm(6)
        args = (_nchw(mask), _nchw(stats))
    else:
        jmod = jlayers.BatchNorm()
        jv = {"params": {"bn": {"scale": scale, "bias": bias}},
              "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
        y, st = jmod.apply(jv, jnp.asarray(x), True, mutable=["batch_stats"])
        st = st["batch_stats"]["bn"]
        tmod = tlayers.BatchNorm(6)
        args = ()
    tmod.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)}, strict=False)
    tmod.train()
    ty = tmod(_nchw(x), *args)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(st["mean"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(st["var"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["max_pool", "avg_pool_binary", "bilinear", "nearest"])
def test_resize_any_shape_matches_jax(kind):
    """``resize_any_shape`` on (b, n_f, n_i, H, W) maps: the pooled binary
    downsamples exactly, the bilinear and nearest resizes within 1e-6."""
    rs = np.random.RandomState(4)
    x = (rs.rand(1, 2, 3, 32, 48) > 0.7).astype(np.float32) if "pool" in kind else \
        rs.rand(1, 2, 3, 32, 48).astype(np.float32)
    kw = {"max_pool": dict(scale_factor=0.125, use_max_pool=True),
          "avg_pool_binary": dict(scale_factor=0.25, use_avg_pool_binary=True),
          "bilinear": dict(size=(20, 28)), "nearest": dict(scale_factor=0.5, mode="nearest")}[kind]
    want = np.asarray(jax_resize_any_shape(jnp.asarray(x), **kw))
    got = resize_any_shape(torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=0 if "pool" in kind else 1e-6)


@pytest.mark.parametrize("k_size", [27, 15, 30])
def test_dilate_ellipse_random_matches_jax(k_size):
    """Train-mode random-width dilation with the same injected widths: the
    port's grouped conv against the JAX package's (0/1 maps, exact)."""
    call = {27: 0, 15: 1, 30: 2}[k_size]
    x = (np.random.RandomState(k_size).rand(2, 5, 40, 52) > 0.97).astype(np.float32)
    want = _jax_dilate_with_widths(iter([call]))(jnp.asarray(x), k_size, None)
    got = _PORT_DILATE(torch.from_numpy(x), k_size, widths=torch.from_numpy(_WIDTHS[call]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------ schedules and optimizers
def _opt_cfg(optimizer="adamw", scheduler="cosine"):
    cfg = train_cfg()
    cfg.train.optimizer.name = optimizer
    cfg.train.scheduler.name = scheduler
    return cfg


@pytest.mark.parametrize("name", ["poly", "step", "warmup_decay", "cosine"])
def test_lr_schedule_matches_jax(name):
    """Each schedule indexed by the update count from 0, against the JAX
    package's: 1e-6 relative, and 1e-12 absolute for the cosine's last
    updates, where the JAX package's f32 ``1 + cos`` rounds to 0 and the
    port's f64 one does not (6.0014e-10 against 6.0e-10)."""
    from maggie_tpu.engine.optim import build_lr_schedule as jax_schedule
    from maggie_tpu_torch.engine.optim import build_lr_schedule
    cfg = _opt_cfg(scheduler=name)
    jfn, tfn = jax_schedule(cfg), build_lr_schedule(ConfigNode(cfg.to_dict()))
    for s in (0, 1, 2, 500, 998, 999, 1000, 1001, 9999, 10000, 26000, 51998, 51999, 52000):
        np.testing.assert_allclose(tfn(s), float(jfn(s)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_matches_optax(name):
    """Three updates from the same gradients (one step below the clip's norm,
    two above): the port's clip, learning rate and ``torch.optim`` update
    against the JAX package's optax chain, 1e-6 relative."""
    cfg = _opt_cfg(optimizer=name)
    rs = np.random.RandomState(5)
    params = {"a": rs.randn(4, 6).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (1e-3, 1.0, 3.0)]
    tx, _ = jax_build_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, schedule = build_optimizer(ConfigNode(cfg.to_dict()), tp.values())
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        clip_by_global_norm_([p.grad for p in tp.values()])
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} update {i} {k}")


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    """optax's clip (no epsilon), in place, below and above the 0.01 norm."""
    rs = np.random.RandomState(6)
    gs = [(rs.randn(5, 3) * scale).astype(np.float32), (rs.randn(4) * scale).astype(np.float32)]
    want, _ = optax.clip_by_global_norm(0.01).update([jnp.asarray(g) for g in gs], None)
    got = [torch.from_numpy(g.copy()) for g in gs]
    norm = clip_by_global_norm_(got)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)),
                               rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
