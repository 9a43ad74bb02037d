"""The port's SparseMat (``configs/sparsemat_image.yaml`` and
``sparsemat_video.yaml``, arch ``SparseMat_SingInst``) against ``maggie_tpu``
on the CPU, at the yamls' widths, with the same weights (seeded numpy values
through ``convert_jax``) and inputs:

- the MobileNetV2 taps, the LPN (alpha and context) and ``IBNorm`` in eval
  and train mode, within 1e-5;
- the SHM's blocks (a stride-2 block, the dilated block, a plain block, the
  context gate), eval and train mode: outputs within 1e-5, the masked
  BatchNorm statistics within ``test_torch_train.py``'s ``STATS_ATOL``;
- the image eval forward (SingInst, 2 instances, 128x128), also under
  ``model.precision`` bf16, which SparseMat does not read, and the streaming
  video forward (3 frames, one of which repeats part of the one before, so
  that ``shared`` holds both values), within 1e-5;
- one train step against JAX ``make_train_step``: the loss terms at
  ``test_torch_train.py``'s tolerance, the gradients in total, the
  parameters and the BatchNorm and masked BatchNorm statistics, the SHM's
  at ``test_torch_train.py``'s tolerances and the low-resolution LPN's,
  whose small maps make its step ill-conditioned in f32, at measured looser
  ones (the test's docstring);
- the 10-slot refusal (the JAX package fails on it too), the train step
  taking every ``model.remat`` mode, ``convert_jax``, and
  the CLI: ``--eval-only`` of both yamls on tiny sets, the image ``test()``
  equal to JAX ``test()`` within rtol 1e-4, and training at
  ``dataset.train.max_inst 1``.

Random LPN heads put every low-resolution alpha inside (0.01, 0.99), so the
active set would be the whole map: the final head ``p0x`` is scaled by
``HEAD_SCALE`` (8), which leaves 30% of a frame uncertain and 67% active.
The thresholds decide pixels discretely, so the tests assert that no value
read by them lies within ``MARGIN`` of one (the low-resolution alphas from
0.01 and 0.99, the frame differences from 0.001 and their 9x9 sums from
0.05). Within 0.005 of 0.01 or 0.99 the port's low-resolution alphas lay
at most 7.8e-7 from JAX's (6 frame seeds x 2 instances), so ``MARGIN`` is
1e-6; the image test's frames are seed 1, whose margins are 9.9e-6 and
1.7e-6 (seed 0 puts one alpha 7.7e-7 from 0.01), the video test's seed 8,
whose margins are 7.6e-6 and 3.4e-6.
"""

import copy
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.errors import ScopeParamShapeError
from flax.traverse_util import flatten_dict, unflatten_dict

import maggie_tpu.engine.test as jax_engine
import maggie_tpu_torch.engine.test as port_engine
import maggie_tpu_torch.engine.train_step as port_step
import maggie_tpu_torch.models.sparsemat as tsm
from maggie_tpu.config import load_config as jax_load_config
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu.models.lpn import IBNorm as JaxIBNorm
from maggie_tpu.models.mobilenetv2 import MobileNetV2Backbone as JaxMobileNetV2
from maggie_tpu.models.shm import SparseBasicBlock as JaxBlock
from maggie_tpu.models.shm import SparseCAM as JaxCAM
from maggie_tpu_torch.config import ConfigNode, load_config
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.models.lpn import IBNorm
from maggie_tpu_torch.utils.convert_jax import to_jax
from test_torch_harness import jax_variables, one_torch_thread, port_from_flat, random_flat  # noqa: F401
from test_torch_mgm import LR, _cli, _data_opts, blob, him_root, yaml_path  # noqa: F401
from test_torch_train import (FLAGS, GRAD_REL_L2, LOSS_RTOL, PARAM_ATOL, PARAM_FAR_SHARE,
                              STATS_ATOL, _flat, _l2)
from test_torch_video_train import _keeping_grads

HW = 128
ATOL = 1e-5
RTOL = 1e-4
MARGIN = 1e-6
HEAD_SCALE = 8.0
HEAD = "params/lpn_mod/decoder/p0x/conv/weight"
# the LPN's part of the train step (test_train_step_matches_jax's docstring)
LPN_GRAD_REL_L2 = 0.15
LPN_FAR_SHARE = 0.1
LPN_STATS_ATOL = 1e-4


def jax_shapes(jm) -> dict:
    batch = {"image": jnp.zeros((1, 1, 64, 64, 3)), "mask": jnp.zeros((1, 1, 1, 64, 64))}
    tree = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, batch, train=False))
    return {"/".join(k): v.shape for k, v in flatten_dict(tree).items()}


def build_pair(name: str = "sparsemat_image", seed: int = 0, head_scale: float = HEAD_SCALE):
    """(JAX config, JAX model, JAX variables, port model, flat) of
    ``configs/<name>.yaml`` on identical weights, ``p0x`` scaled."""
    jcfg = jax_load_config(yaml_path(name))
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed)
    flat[HEAD] = flat[HEAD] * np.float32(head_scale)
    return jcfg, jm, jax_variables(flat), port_from_flat(ConfigNode(jcfg.model.to_dict()), flat), flat


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def sub_variables(flat: dict, prefix: str) -> dict:
    """The JAX variables of the module at ``prefix`` (a path under the
    collections), for applying it alone."""
    out = {}
    for k, v in flat.items():
        coll, rest = k.split("/", 1)
        if rest.startswith(prefix + "/"):
            out[(coll,) + tuple(rest[len(prefix) + 1:].split("/"))] = v
    return unflatten_dict(out)


def nchw(a) -> np.ndarray:
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def nhwc(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy())


def close(got: torch.Tensor, want, err_msg: str, atol: float = ATOL, layout=nchw):
    want = layout(want) if layout is not None else np.asarray(want)
    assert tuple(got.shape) == want.shape, (err_msg, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=atol * max(1.0, float(np.abs(want).max())), err_msg=err_msg)


def blobs_mask(n: int, hw: int, seed: int) -> torch.Tensor:
    """(n, 1, hw, hw) 0/1 masks of a few discs."""
    rs = np.random.RandomState(seed)
    m = np.zeros((n, 1, hw, hw), np.float32)
    for i in range(n):
        for _ in range(3):
            m[i, 0] = np.maximum(m[i, 0], blob(hw, hw, rs.randint(hw), rs.randint(hw),
                                               hw // 5) > 0.5)
    return torch.from_numpy(m)


# ------------------------------------------------------------------ modules
def test_mobilenetv2_lpn_and_ibnorm_match_jax(pair):
    """The backbone's five taps and the LPN's (alpha, dec16x) on a 4-channel
    64x64 input in eval mode; ``IBNorm`` alone in eval and train mode, with
    its BatchNorm's statistics after the train step."""
    _, jm, _, tm, flat = pair
    flat = {**flat, HEAD: flat[HEAD] / np.float32(HEAD_SCALE)}   # the LPN at its own weights
    lpn = copy.deepcopy(tm.lpn)
    lpn.decoder.p0x.conv.weight.data /= HEAD_SCALE
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 4, 64, 64).astype(np.float32))

    @jax.jit
    def jax_lpn(v, x):
        taps = JaxMobileNetV2().apply(sub_variables(v, "lpn_mod/backbone"), x)
        return taps, jm.apply(jax_variables(v), x, method=lambda m, x: m.lpn(x, False))
    taps, (alpha, ctx) = jax_lpn(flat, nhwc(x))
    with torch.no_grad():
        got_taps = lpn.backbone(x)
        got_alpha, got_ctx = lpn(x)
    assert [t.shape[1] for t in got_taps] == [16, 24, 32, 96, 1280]
    for i, (g, w) in enumerate(zip(got_taps, taps)):
        close(g, w, f"tap {i}")
    close(got_alpha, alpha, "alpha")
    close(got_ctx, ctx, "dec16x")

    prefix = "lpn_mod/decoder/conv_dec8x_0/ibn"
    y = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 8, 12).astype(np.float32))
    ibn = copy.deepcopy(tm.lpn.decoder.conv_dec8x_0.ibn)
    assert isinstance(ibn, IBNorm)
    variables = sub_variables(flat, prefix)
    for train in (False, True):
        want = JaxIBNorm().apply(variables, nhwc(y), train, mutable=["batch_stats"])
        got = ibn.train(train)(y)
        close(got, want[0], f"IBNorm train={train}")
    stats = want[1]["batch_stats"]["bnorm"]["bn"]
    np.testing.assert_allclose(ibn.bnorm.running_mean.numpy(), np.asarray(stats["mean"]),
                               atol=STATS_ATOL)
    np.testing.assert_allclose(ibn.bnorm.running_var.numpy(), np.asarray(stats["var"]),
                               atol=STATS_ATOL)


@pytest.mark.parametrize("layer,block,inp,hw,jax_args", [
    (1, 0, 64, 32, (64, 2, 1, True)),       # stride 2: the strided conv, its active set
    (4, 0, 256, 16, (512, 1, 2, True)),     # dilation 2, the submanifold downsample
    (3, 1, 256, 16, (256, 1, 1, False)),    # plain
])
def test_shm_block_matches_jax(pair, layer, block, inp, hw, jax_args):
    """One ``SparseBasicBlock`` of the SHM's ResNet-18, eval then train mode:
    the output and its active set, and the masked BatchNorm statistics the
    train pass steps."""
    _, _, _, tm, flat = pair
    prefix = f"shm_mod/backbone/layer{layer}_block{block}"
    variables = sub_variables(flat, prefix)
    port = copy.deepcopy(tm.shm.backbone.__getattr__(f"layer{layer}")[block])
    x = torch.from_numpy(np.random.RandomState(layer).randn(2, inp, hw, hw).astype(np.float32))
    m = blobs_mask(2, hw, layer)
    x = x * m
    for train in (False, True):
        (want, wm), mutated = JaxBlock(*jax_args).apply(variables, nhwc(x), nhwc(m), train,
                                                        mutable=["batch_stats"])
        got, gm = port.train(train)(x, m)
        close(got, want, f"train={train}")
        np.testing.assert_array_equal(gm.numpy(), nchw(wm))
    assert 0.1 < float(gm.mean()) < 0.9
    tkey = f"shm.backbone.layer{layer}.{block}"
    got = to_jax({f"{tkey}.{k}": v for k, v in port.state_dict().items()})
    for k, v in flatten_dict(mutated["batch_stats"]).items():
        jkey = f"batch_stats/{prefix}/" + "/".join(k)
        np.testing.assert_allclose(got[jkey], np.asarray(v), atol=STATS_ATOL, err_msg=jkey)


def test_sparse_cam_matches_jax(pair):
    """The context gate on a masked bottleneck."""
    _, _, _, tm, flat = pair
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(2, 512, 8, 8).astype(np.float32))
    m = blobs_mask(2, 8, 3)
    ctx = torch.from_numpy(rs.randn(2, 32, 4, 4).astype(np.float32))
    lr = torch.from_numpy(rs.rand(2, 1, 64, 64).astype(np.float32))
    want = JaxCAM(512, 32).apply(sub_variables(flat, "shm_mod/ctx"), nhwc(x), nhwc(m),
                                 nhwc(ctx), nhwc(lr))
    with torch.no_grad():
        close(tm.shm.ctx(x, m, ctx, lr), want, "SparseCAM")


# --------------------------------------------------------------------- eval
def frames(n_f: int, n_i: int, seed: int = 0, repeat: bool = False):
    """(JAX batch, port batch): noise frames, disc masks moving 3 px a frame.
    With ``repeat``, frame 2 copies the top half of frame 1 exactly."""
    rs = np.random.RandomState(seed)
    img = rs.rand(1, n_f, HW, HW, 3).astype(np.float32)
    if repeat:
        img[0, 2, :HW // 2] = img[0, 1, :HW // 2]
    mask = np.stack([[blob(HW, HW, 40 + 40 * j + 3 * t, 50 + 20 * j, 30) > 0.5
                      for j in range(n_i)] for t in range(n_f)])[None].astype(np.float32)
    b = {"image": img, "mask": mask}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


class Margins:
    """Record the distances of the values that ``SparseMat``'s thresholds
    read: the alphas ``dilate`` reads from 0.01 and 0.99, and, per frame
    pair, the frame difference from 0.001 and its 9x9 sum from 0.05; the
    share of each dilated map, and the ``shared`` maps."""

    def __init__(self):
        self.alpha, self.active, self.diff, self.shared = [], [], [], []

    def __enter__(self):
        self.orig = (tsm.SparseMat.dilate, tsm.SparseMat.generate_sparsity_map)
        rec = self

        def dilate(model, a):
            d = torch.minimum((a - 0.01).abs(), (a - 0.99).abs())
            rec.alpha.append(float(d.detach().min()))
            out = rec.orig[0](model, a)
            rec.active.append(float(out.detach().mean()))
            return out

        def sparsity(model, lr_pred, curr, last):
            diff = (curr - last).abs().mean(dim=1, keepdim=True)
            rec.diff.append(min(float((diff - 0.001).abs().min()),
                                float((tsm.box_sum(diff, 9) - 0.05).abs().min())))
            out = rec.orig[1](model, lr_pred, curr, last)
            rec.shared.append(out[3])
            return out
        tsm.SparseMat.dilate, tsm.SparseMat.generate_sparsity_map = dilate, sparsity
        return self

    def __exit__(self, *exc):
        tsm.SparseMat.dilate, tsm.SparseMat.generate_sparsity_map = self.orig


def test_image_eval_matches_jax(pair):
    """``SparseMat_SingInst`` on a 128x128 frame with 2 instances, one at a
    time: ``refined_masks`` within 1e-5, the active set neither empty nor
    full, the thresholds' margins held."""
    _, jm, jv, tm, _ = pair
    jb, tb = frames(1, 2, seed=1)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(jv, jb)
    with Margins() as rec:
        got = tm(tb)
    assert set(got) == set(want) == {"refined_masks"}
    close(got["refined_masks"], want["refined_masks"], "refined_masks", layout=None)
    assert len(rec.alpha) == 2 and min(rec.alpha) >= MARGIN, rec.alpha
    assert got["refined_masks"].shape == (1, 1, 2, HW, HW)
    assert all(0.1 < a < 0.9 for a in rec.active), rec.active


def test_video_streaming_matches_jax(pair):
    """The streaming fusion over 3 frames at one instance
    (``sparsemat_video.yaml``'s arch): frame 2 repeats the top half of
    frame 1, so ``shared`` is 1 there and 0 elsewhere, and that frame takes
    the previous output where the active set leaves it; within 1e-5."""
    _, jm, jv, tm, _ = pair
    jb, tb = frames(3, 1, seed=8, repeat=True)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(jv, jb)
    with Margins() as rec:
        got = tm(tb)
    close(got["refined_masks"], want["refined_masks"], "refined_masks", layout=None)
    shared = rec.shared[0]
    assert shared.shape == (2, 1, HW, HW)
    assert float(shared[0].max()) == 0.0                   # frame 1 vs 0: all changed
    assert 0.3 < float(shared[1].mean()) < 0.6              # frame 2 vs 1: the top half
    assert min(rec.alpha) >= MARGIN and min(rec.diff) >= MARGIN, (rec.alpha, rec.diff)


def test_bf16_precision_runs_f32(pair):
    """As in the JAX package, SparseMat reads no ``model.precision``: built
    under bf16 with the same weights, its eval output equals the f32
    model's bit for bit."""
    _, _, _, tm, _ = pair
    cfg = load_config(yaml_path("sparsemat_image")).model
    cfg.precision = "bf16"
    half = build_model(cfg, device="cpu").eval()
    half.load_state_dict(tm.state_dict())
    _, tb = frames(1, 2, seed=1)
    with torch.no_grad():
        assert torch.equal(half(tb)["refined_masks"], tm(tb)["refined_masks"])


# ----------------------------------------------------------------- training
def train_batch(n: int = 2, hw: int = HW, slots: int = 1, seed: int = 0):
    """Soft discs: the alphas, their masks (> 0.5), transitions."""
    rs = np.random.RandomState(seed)
    alpha = np.zeros((n, 1, slots, hw, hw), np.float32)
    for i in range(n):
        for j in range(slots):
            alpha[i, 0, j] = blob(hw, hw, rs.randint(hw // 4, 3 * hw // 4),
                                  rs.randint(hw // 4, 3 * hw // 4), hw // 4)
    b = {"image": rs.rand(n, 1, hw, hw, 3).astype(np.float32),
         "mask": (alpha > 0.5).astype(np.float32), "alpha": alpha,
         "transition": ((alpha > 0) & (alpha < 1)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _rel_l2(got: dict, want: dict) -> float:
    return float(np.sqrt(sum(_l2(got[k] - w) ** 2 for k, w in want.items()))
                 / np.sqrt(sum(_l2(w) ** 2 for w in want.values())))


def test_train_step_matches_jax():
    """One step at batch 2 x 128x128 from identical variables:
    ``loss_rec``, ``loss_lap``, ``loss_grad`` and ``total`` within
    ``LOSS_RTOL``; the gradients before the clip in total (relative L2),
    the SHM's within ``GRAD_REL_L2``, the LPN's within ``LPN_GRAD_REL_L2``
    (the module docstring of ``test_torch_train.py`` and below); the parameters
    after the step, and the BatchNorm (LPN) and masked BatchNorm (SHM)
    statistics within ``STATS_ATOL``. The forward draws nothing.

    The LPN trains on the low resolution: its last stages' BatchNorms see
    2x2 sites a frame and its instance norms 4x4, so f32 rounding moves its
    gradients by percents. Against an evaluation of the port with every
    conv in f64 (the norms stay f32), the port's f32 LPN gradients lay 3.4%
    (relative L2) away and XLA:CPU's 10.1%; port and JAX 8.9% apart. The
    SHM's: 0.5%, 1.7% and 1.6% in total, but up to 6.5% on one tensor (its
    first masked BatchNorm's bias), so the SHM is held in total too, not
    per tensor as in ``test_torch_train.py``; the module tests above hold
    its blocks at 1e-5. The parameters after the step: none further than
    2 lr + ``PARAM_ATOL`` (Adam's first step is about lr times the
    gradient's sign), and the share further than ``PARAM_ATOL``, where a
    gradient's noise flips its sign, the SHM's within ``PARAM_FAR_SHARE``
    (read 1.8%), the LPN's within ``LPN_FAR_SHARE`` (read 6.0%). The
    statistics: the SHM's within ``STATS_ATOL``, the LPN's within
    ``LPN_STATS_ATOL`` (read 3.7e-5, at the last stage's 4x4 maps)."""
    jcfg, jm, jv, tm, _ = build_pair()
    jb, tb = train_batch()
    tx = _keeping_grads(jax_build_optimizer(jcfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                           opt_state=tx.init(jv["params"]), batch_stats=jv["batch_stats"],
                           spectral={})
    jstate, jld = jax_make_train_step(jm, tx)(jstate, jb, jax.random.PRNGKey(1), **FLAGS)
    tm.train()
    opt, schedule = build_optimizer(ConfigNode(jcfg.to_dict()), tm.parameters())
    state = TrainState(tm, opt)
    grads = {}
    clip = port_step.clip_by_global_norm_

    def before_clip(gs):
        grads.update({k: p.grad.clone() for k, p in tm.named_parameters()})
        return clip(gs)
    with Margins() as rec, pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_step, "clip_by_global_norm_", before_clip)
        tld = make_train_step(tm, opt, schedule)(state, tb, None, **FLAGS)
    assert min(rec.alpha) >= MARGIN and 0.1 < rec.active[0] < 0.99, (rec.alpha, rec.active)
    check_train_step(jstate, jld, state, tld, grads)


def check_train_step(jstate, jld, state, tld, grads: dict) -> None:
    """A port step (its state after, loss dict and gradients before the
    clip) against JAX's at ``test_train_step_matches_jax``'s limits."""
    assert set(tld) == set(jld) == {"loss_rec", "loss_lap", "loss_grad", "total"}
    for k, v in jld.items():
        np.testing.assert_allclose(float(tld[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    want, got = _flat("params", jstate.opt_state[1]), to_jax(grads)
    part = lambda d, p: {k: v for k, v in d.items() if k.startswith(p)}
    shm, lpn = part(want, "params/shm_mod/"), part(want, "params/lpn_mod/")
    assert set(got) == set(want) and len(shm) + len(lpn) == len(want)
    assert _rel_l2(got, shm) <= GRAD_REL_L2, _rel_l2(got, shm)
    assert _rel_l2(got, lpn) <= LPN_GRAD_REL_L2, _rel_l2(got, lpn)
    assert state.step == int(jstate.step) == 1
    want, got = _flat("params", jstate.params), to_jax(state.params())
    assert set(got) == set(want)
    d = {k: np.abs(got[k] - w) for k, w in want.items()}
    assert max(float(v.max()) for v in d.values()) <= 2 * LR + PARAM_ATOL
    for p, share in (("params/shm_mod/", PARAM_FAR_SHARE), ("params/lpn_mod/", LPN_FAR_SHARE)):
        far = sum(int((v > PARAM_ATOL).sum()) for k, v in d.items() if k.startswith(p))
        size = sum(v.size for k, v in d.items() if k.startswith(p))
        assert far <= share * size, (p, far / size)
    want, got = _flat("batch_stats", jstate.batch_stats), to_jax(state.batch_stats())
    assert set(got) == set(want)
    for p, tol in (("batch_stats/shm_mod/", STATS_ATOL), ("batch_stats/lpn_mod/", LPN_STATS_ATOL)):
        worst = max((float(np.abs(got[k] - w).max()), k) for k, w in want.items()
                    if k.startswith(p))
        assert worst[0] <= tol, worst


def test_takes_remat_and_refuses_ten_slots(pair):
    """The train forward at 10 slots (``sparsemat_*.yaml``'s
    ``dataset.train.max_inst``) raises naming ``dataset.train.max_inst``;
    the JAX package, initialised at one slot as its ``train()`` does, fails
    on the same batch at the LPN's first conv (ROADMAP.md queue 3). The
    train step takes every ``model.remat`` mode
    (``tests/test_torch_baseline_remat.py`` holds the remat steps)."""
    jcfg, jm, jv, tm, _ = pair
    jb, tb = train_batch(n=1, hw=64, slots=10)
    with pytest.raises(ScopeParamShapeError, match="features_0/conv"):
        jm.apply(jv, jb, train=True, mutable=["batch_stats"])
    model = copy.deepcopy(tm).train()
    with pytest.raises(ValueError, match="dataset.train.max_inst"):
        model(tb)
    opt, schedule = build_optimizer(ConfigNode(jcfg.to_dict()), model.parameters())
    for mode in ("none", "full", "selective", False, True):
        assert callable(make_train_step(model, opt, schedule, remat=mode))
    with pytest.raises(ValueError, match="must be one of"):
        make_train_step(model, opt, schedule, remat="sometimes")


def test_convert_jax_leaves_nothing_over(pair):
    """Every JAX array lands in the port and ``to_jax`` gives the tree back,
    for the whole model and for its parameters alone."""
    _, _, _, tm, flat = pair
    back = to_jax(tm.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert set(to_jax(dict(tm.named_parameters()))) == {k for k in flat if k.startswith("params/")}


# ---------------------------------------------------------------------- CLI
def test_image_test_matches_jax(him_root, tmp_path):
    """``test()`` of ``sparsemat_image.yaml`` on the tiny HIM set (2 frames of
    64x96, 2 instances, one forward each): every metric within rtol 1e-4 of
    JAX ``test()`` without shape bucketing; then the CLI's ``--eval-only``
    on the same set, every metric finite."""
    opts = _data_opts(him_root, tmp_path) + ["test.shape_bucketing", "False"]
    _, _, jv, _, flat = build_pair()
    jres = jax_engine.test(jax_load_config(yaml_path("sparsemat_image"), opts), variables=jv)
    pcfg = load_config(yaml_path("sparsemat_image"), opts)
    with Margins() as rec:
        pres = port_engine.test(pcfg, model=port_from_flat(pcfg.model, flat))
    assert len(rec.alpha) == 4 and min(rec.alpha) >= MARGIN, rec.alpha
    assert list(pres) == list(jres)
    assert list(pres)[:5] == ["MAD", "MSE", "SAD", "Grad", "Conn"]
    for k in jres:
        np.testing.assert_allclose(pres[k], jres[k], rtol=RTOL, err_msg=k)
    res = _cli("sparsemat_image", "--eval-only", *_data_opts(him_root, tmp_path / "cli"))
    assert set(res) == set(jres) and all(np.isfinite(v) for v in res.values())


def test_cli_video_eval_only(tmp_path):
    """``sparsemat_video.yaml --eval-only`` on one VIM video of 4 frames
    (2 windows): the seven metrics, finite, in ``results.csv``."""
    from PIL import Image
    split = tmp_path / "vim" / "medium"
    rs = np.random.RandomState(0)
    (split / "fgr" / "vid0").mkdir(parents=True)
    for t in range(4):
        Image.fromarray(rs.randint(0, 255, (64, 96, 3), np.uint8)).save(
            split / "fgr" / "vid0" / f"{t:04d}.jpg")
        a = (blob(64, 96, 30 + 2 * t, 32, 16) * 255).astype(np.uint8)
        for d, arr in (("pha", a), ("xmem", ((a > 127) * 255).astype(np.uint8))):
            (split / d / "vid0" / f"{t:04d}").mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(split / d / "vid0" / f"{t:04d}" / "00.png")
    res = _cli("sparsemat_video", "--eval-only", "name", "run", "output_dir", str(tmp_path),
               "dataset.test.root_dir", str(tmp_path / "vim"), "dataset.test.split", "medium",
               "dataset.test.short_size", "64", "test.log_iter", "1")
    assert set(res) >= {"MAD", "MSE", "SAD", "Grad", "Conn", "dtSSD", "MESSDdt"}
    assert all(np.isfinite(v) for v in res.values())
    assert (tmp_path / "run" / "results.csv").is_file()


def test_cli_trains_at_one_slot(him_root, tmp_path):
    """``sparsemat_image.yaml`` as written (``dataset.train.max_inst`` 10)
    raises at its first step, naming the key; at ``max_inst`` 1 two
    iterations run, with a validation, and write the checkpoints."""
    opts = (*_data_opts(him_root, tmp_path), "train.batch_size", "2", "train.max_iter", "2",
            "train.log_iter", "1", "train.val_iter", "2")
    with pytest.raises(ValueError, match="dataset.train.max_inst"):
        _cli("sparsemat_image", *opts)
    state = _cli("sparsemat_image", *opts, "dataset.train.max_inst", "1")
    assert state.step == 2
    for f in ("last_state.pt", "best_model.npz"):
        assert (tmp_path / "run" / f).is_file(), f
    with np.load(tmp_path / "run" / "best_model.npz") as npz:
        assert "params/shm_mod/backbone/conv1/weight" in npz.files


def test_built_model_is_seeded_and_finite():
    """``build_model`` of the video yaml on the CPU: the same generator seed
    gives the same weights, and the eval forward is finite in [0, 1]."""
    cfg = load_config(yaml_path("sparsemat_video")).model
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    out = a(frames(2, 1)[1])["refined_masks"]
    assert out.shape == (1, 2, 1, HW, HW) and 0 <= float(out.min()) <= float(out.max()) <= 1
