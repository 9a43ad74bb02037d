"""The port's MGM baselines (``configs/mgm.yaml``, arch ``MGM_SingInst``, and
``configs/mgm_stacked.yaml``, arch ``MaGGIe`` with the dense decoder) against
``maggie_tpu`` on the CPU, at full width on 64x64 frames, with the same
weights (seeded numpy values through ``convert_jax``) and inputs.

- the ``res_shortcut_29`` encoder and the ``res_shortcut_22`` decoder alone,
  and the eval forward of both configs (``mgm`` at 3 instances, one at a
  time), within 1e-5;
- ``MaGGIe.fuse``: the two bands (K2's twin at k=30 and k=15 in eval, the
  random-width dilation in train with the widths fed the same on both sides,
  as ``test_torch_train.py`` does) exactly equal, and the fused alpha;
- one train step of ``mgm_stacked`` against JAX ``make_train_step`` at
  ``test_torch_train.py``'s tolerances (its docstring gives their reasons),
  on a 128x128 frame as there: at 64x64 the os32 BatchNorms' statistics
  span 4 sites, and the train-mode net then moved a running variance 2.3e-5
  (1.4e-5 relative) from JAX's, against 4.4e-6 at 128x128. Its heads are
  scaled by ``TRAIN_HEAD_SCALE`` 4: the fusion's bands cover 94-96% of the
  true instances' pixels (all of them unscaled), and the loss terms agree
  within 2.3e-6 (at ``HEAD_SCALE`` 8, which multiplies the logits'
  difference by 8, ``loss_grad_os4`` read 2.8e-5);
- ``convert_jax`` with no port tensor missing and no JAX array left over,
  for the four configs of the family;
- the CLI on the CPU: ``--eval-only`` on ``mgm.yaml`` over a tiny HIM set,
  and two training iterations of ``mgm_stacked.yaml``;
- that the family's train step takes every ``model.remat`` mode, and that
  it refuses a train set with more slots than ``encoder_args.num_mask``
  (the JAX package fails on the SingInst yamls' 10-slot train set:
  ROADMAP.md queue 3).

Random heads put almost every alpha inside (1/255, 254/255), so the final
convs of the three heads are scaled by ``HEAD_SCALE``: the logits spread to
where the thresholds of K2 cut them. The fusion's two thresholds decide a
pixel discretely, and a difference of float rounding at one of them would
move an alpha by up to 1; the tests assert that no value that K2 reads in the
true instances' slots lies within ``MARGIN`` of a threshold, as
``test_torch_video.py::threshold_margins`` does. Within 1e-3 of a threshold
the port's alphas lay at most 1.2e-7 (two f32 ulps at 254/255) from JAX's
over 3 weight seeds x 2 inputs of each config, so ``MARGIN`` is 2e-7;
elsewhere the scaled heads leave up to 4.4e-6 between them, inside the 1e-5
bound. The eval tests' weights are ``EVAL_SEED`` 2: of seeds 0-5 at
``HEAD_SCALE`` 8, the one whose clips keep ``MARGIN`` in all four configs
(each other seed puts a value within 1.2e-7 of a threshold in at least one;
``test_torch_tcvom.py`` adds the FAM band's thresholds).
"""

import contextlib
import copy
import itertools
import logging
import os
import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

import maggie_tpu.ops.morphology as jmorph
import maggie_tpu_torch.models.maggie as tmaggie
import maggie_tpu_torch.ops.morphology as tmorph
from maggie_tpu.config import load_config as jax_load_config
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.main import main
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.ops.kernels import unknown as ku
from maggie_tpu_torch.utils.convert_jax import to_jax
from test_torch_harness import (jax_step_lock, jax_variables, one_torch_thread,  # noqa: F401
                                port_from_flat, random_flat, shared_shapes)
from test_torch_train import (FLAGS, LOSS_RTOL, _check_grads, _check_state, _flat,
                              port_step_keeping_grads)
from test_torch_video_train import _keeping_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
TRAIN_HW = 128
ATOL = 1e-5
MARGIN = 2e-7
EVAL_SEED = 2
HEAD_SCALE = 8.0
TRAIN_HEAD_SCALE = 4.0
LR = 1.5e-4 / 25   # the yamls' cosine schedule at update 0 (warmup 1000, test_torch_train)
FAMILY = ("mgm", "mgm_stacked", "mgm_tcvom", "mgm_stacked_tcvom")


def yaml_path(name: str) -> str:
    return os.path.join(REPO, "configs", f"{name}.yaml")


def jax_shapes(jm, n_f: int) -> dict:
    """The JAX model's flat variable shapes, from ``eval_shape`` of its init
    (once a process for each model and clip length)."""
    batch = {"image": jnp.zeros((1, n_f, HW, HW, 3)), "mask": jnp.zeros((1, n_f, 1, HW, HW))}
    return shared_shapes(f"mgm jax_shapes {jm!r} {n_f}",
                         lambda: jm.init({"params": jax.random.PRNGKey(0)}, batch, train=False))


def build_pair(name: str, seed: int = EVAL_SEED, opts=(), head_scale: float = HEAD_SCALE):
    """(JAX config, JAX model, JAX variables, port model, flat) of
    ``configs/<name>.yaml`` on identical weights, the heads' final convs
    scaled by ``head_scale``."""
    jcfg = jax_load_config(yaml_path(name), list(opts))
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm, 3 if "tcvom" in name else 1), seed)
    for k in flat:
        if re.fullmatch(r"params/decoder_mod/refine_OS\d/conv2/(weight|bias)", k):
            flat[k] = flat[k] * np.float32(head_scale)
    tm = port_from_flat(ConfigNode(jcfg.model.to_dict()), flat)
    return jcfg, jm, jax_variables(flat), tm, flat


def blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return np.clip((r - d) / max(r * 0.3, 1), 0, 1)


def frames(n_f: int, n_i: int, seed: int = 0, hw: int = HW):
    """(JAX batch, port batch): noise frames and disc masks that move 3 px a frame."""
    rs = np.random.RandomState(seed)
    mask = np.stack([[blob(hw, hw, 16 + 14 * j + 3 * t, 20 + 10 * j, 12) > 0.5
                      for j in range(n_i)] for t in range(n_f)])[None]
    b = {"image": rs.rand(1, n_f, hw, hw, 3).astype(np.float32), "mask": mask.astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@contextlib.contextmanager
def k2_margins(slots: int | None = None, module=tmaggie):
    """Record how far the maps K2 reads (``module.compute_unknown``) lie from
    its two thresholds in their first ``slots`` slots (all where None: the
    rest are padding, whose outputs are dropped); yields the list of
    distances, one per call."""
    rec = []
    orig = module.compute_unknown

    def spy(a, k_size=30):
        t = a[:, :slots]
        rec.append(min(float((t - ku._LO).abs().min()), float((t - ku._HI).abs().min())))
        return orig(a, k_size)
    module.compute_unknown = spy
    try:
        yield rec
    finally:
        module.compute_unknown = orig


def assert_close(got: dict, want: dict, keys=("alpha_os1", "alpha_os4", "alpha_os8",
                                               "refined_masks")):
    assert set(got) == set(want) == set(keys), (sorted(got), sorted(want))
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)


# ------------------------------------------------------------ modules and eval
@pytest.fixture(scope="module")
def stacked():
    return build_pair("mgm_stacked")


def test_encoder_and_decoder_match_jax(stacked):
    """``res_shortcut_29`` (RGB | 10 masks, no embedding) and then
    ``res_shortcut_22`` on its outputs, eval mode: the trunk, the five skip
    features and the three alphas within 1e-5."""
    _, jm, jv, tm, _ = stacked
    rs = np.random.RandomState(1)
    x = rs.rand(2, HW, HW, 13).astype(np.float32)

    def jfn(m, x):
        out, mid = m.encoder(x, train=False)
        emb = m.aspp(out, train=False)
        return out, mid["shortcut"], m.decoder(emb, mid, b=2, n_f=1, n_i=10, train=False)
    jout, jsc, jpred = jax.jit(lambda v, x: jm.apply(v, x, method=jfn))(jv, jnp.asarray(x))
    with torch.no_grad():
        out, mid = tm.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
        pred = tm.decoder(tm.aspp(out), mid)
    nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))
    for i, (g, w) in enumerate(zip((out,) + mid["shortcut"], (jout,) + tuple(jsc))):
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(np.asarray(w)).max())),
                                   err_msg=f"encoder output {i}")
    assert set(pred) == set(jpred) == {"alpha_os1", "alpha_os4", "alpha_os8"}
    for k, v in pred.items():
        assert v.dtype == torch.float32 and v.shape == (2, 10, HW, HW)
        np.testing.assert_allclose(v.numpy(), np.asarray(jpred[k]), rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name,n_i", [("mgm", 3), ("mgm_stacked", 3)])
def test_eval_forward_matches_jax(name, n_i, stacked):
    """The whole eval forward, K2 in the fusion (its plain twin here):
    ``alpha_os*`` and ``refined_masks`` within 1e-5, every K2 input at least
    MARGIN from its thresholds, two K2 calls per harness forward (one
    harness forward per instance for ``MGM_SingInst``)."""
    _, jm, jv, tm, _ = stacked if name == "mgm_stacked" else build_pair(name)
    jb, tb = frames(1, n_i)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(jv, jb)
    with k2_margins(n_i) as margins:
        got = tm(tb)
    assert len(margins) == (2 * n_i if name == "mgm" else 2)
    assert min(margins) >= MARGIN, margins
    assert_close(got, want)
    assert got["refined_masks"].shape == (1, 1, n_i, HW, HW)


def _fuse_inputs(n: int = 2, n_i: int = 3):
    """Soft discs: a8, and a4 and a1 that differ from it, so that the fused
    alpha shows which source each pixel took."""
    rs = np.random.RandomState(3)
    a8 = np.stack([[blob(HW, HW, rs.randint(10, 54), rs.randint(10, 54), rs.randint(6, 16))
                    for _ in range(n_i)] for _ in range(n)]).astype(np.float32)
    a4 = np.clip(a8 + rs.uniform(-0.2, 0.2, a8.shape), 0, 1).astype(np.float32)
    a1 = rs.rand(*a8.shape).astype(np.float32)
    return {"alpha_os1": a1, "alpha_os4": a4, "alpha_os8": a8}


# the widths of a train fusion's two random-width dilations (k=30, then k=15)
_FUSE_WIDTHS = [np.random.RandomState(k).randint(1, k, 6) for k in (30, 15)]


def _jax_dilate_with(widths_list, calls):
    def dilate(binary, k_size, rng):
        widths = widths_list[next(calls) % len(widths_list)]
        assert widths.max() < k_size
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


def _port_dilate_with(widths_list, calls):
    orig = tmorph.dilate_ellipse_random

    def dilate(binary, k_size, generator=None):
        return orig(binary, k_size, widths=torch.from_numpy(widths_list[next(calls) % len(widths_list)]))
    return dilate


@contextlib.contextmanager
def same_widths(widths_list):
    """Both packages' random-width dilations take the widths of ``widths_list``
    in call order (``test_torch_train.py``'s monkeypatch)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmorph, "dilate_ellipse_random", _jax_dilate_with(widths_list, itertools.count()))
        mp.setattr(tmorph, "dilate_ellipse_random", _port_dilate_with(widths_list, itertools.count()))
        yield


@pytest.mark.parametrize("train", [False, True])
def test_fuse_matches_jax(stacked, train):
    """``MaGGIe.fuse`` on the same alphas: the os4 and os1 bands exactly
    equal (eval: K2's twin at k=30 and k=15; train: the random widths fed
    the same), each band neither empty nor full, and the fused alpha
    exactly equal (a pixel takes a source's value as it is)."""
    _, jm, jv, tm, _ = stacked
    pred = _fuse_inputs()
    with same_widths(_FUSE_WIDTHS):
        ja, jw4, jw1 = jm.apply(jv, {k: jnp.asarray(v) for k, v in pred.items()}, train,
                                jax.random.PRNGKey(0), jax.random.PRNGKey(1), method="fuse")
        model = copy.deepcopy(tm).train(train)
        ta, tw4, tw1 = model.fuse({k: torch.from_numpy(v) for k, v in pred.items()},
                                  torch.Generator())
    for name, g, w in (("w4", tw4, jw4), ("w1", tw1, jw1), ("alpha", ta, ja)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for band in (tw4, tw1):
        assert 0 < float(band.mean()) < 1
    assert set(np.unique(tw4.numpy())) == {0.0, 1.0}


def test_bf16_sends_f32_alphas_to_k2(stacked):
    """Under ``--precision 16`` (``model.precision bf16``) the dense decoder
    casts its heads to f32, so K2 gets f32 alphas; the kernel's wrapper
    keeps refusing anything else."""
    jcfg, _, _, _, flat = stacked
    cfg = ConfigNode(jcfg.model.to_dict())
    cfg.precision = "bf16"
    model = port_from_flat(cfg, flat)
    seen = []
    orig = tmaggie.compute_unknown
    tmaggie.compute_unknown = lambda a, k: seen.append(a.dtype) or orig(a, k)
    try:
        out = model(frames(1, 2)[1])
    finally:
        tmaggie.compute_unknown = orig
    assert seen == [torch.float32, torch.float32]
    assert out["refined_masks"].dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        ku._launch(torch.zeros(1, 1, 8, 8, dtype=torch.bfloat16), 30)


@pytest.mark.parametrize("name", FAMILY)
def test_convert_jax_leaves_nothing_over(name):
    """Every JAX array of the config's variable tree lands in the port and
    ``to_jax`` gives the tree back: the MGM encoder directly under
    ``encoder_mod``, the dense decoder's heads, TCVOM's FAM convs."""
    jcfg = jax_load_config(yaml_path(name))
    jm = jax_build_model(jcfg.model)
    shapes = jax_shapes(jm, 3 if "tcvom" in name else 1)
    flat = random_flat(shapes, seed=5)
    model = port_from_flat(ConfigNode(jcfg.model.to_dict()), flat)
    back = to_jax(model.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["encoder.conv1.module.weight_bar"].numpy(),
        np.transpose(flat["params/encoder_mod/conv1/weight_bar"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["decoder.conv1.module.weight_bar"].numpy(),
        np.transpose(flat["params/decoder_mod/conv1/weight_bar"], (2, 3, 0, 1)))
    # the parts a train state's checks read map alone as the whole does
    for part in (dict(model.named_parameters()),
                 {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))},
                 {k: v for k, v in sd.items() if k.endswith(("weight_u", "weight_v"))}):
        assert set(to_jax(part)) <= set(flat)


# ------------------------------------------------------------------ training
def train_batch(seed: int = 0, n_f: int = 1, slots: int = 10, n_i: int = 3, hw: int = TRAIN_HW):
    """Soft discs in ``n_i`` of ``slots`` slots, moving 2 px a frame; masks
    the alphas above 0.5; transitions the pixels strictly between 0 and 1."""
    rs = np.random.RandomState(seed)
    alpha = np.zeros((1, n_f, slots, hw, hw), np.float32)
    for j in range(n_i):
        cx, cy, r = (int(v * hw / 64) for v in (rs.randint(16, 48), rs.randint(16, 48),
                                                  rs.randint(10, 18)))
        for t in range(n_f):
            alpha[0, t, j] = blob(hw, hw, cx + 2 * t, cy, r)
    b = {"image": rs.rand(1, n_f, hw, hw, 3).astype(np.float32),
         "mask": (alpha > 0.5).astype(np.float32), "alpha": alpha,
         "transition": ((alpha > 0) & (alpha < 1)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def step_pair(name: str, jb, tb, widths):
    """One step of JAX ``make_train_step`` and of the port's from identical
    variables, the random widths fed the same. Returns (JAX state, JAX loss
    dict, port state, port loss dict, port gradients before the clip)."""
    jcfg, jm, jv, tm, _ = build_pair(name, head_scale=TRAIN_HEAD_SCALE)
    tx = _keeping_grads(jax_build_optimizer(jcfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                           opt_state=jax.jit(tx.init)(jv["params"]), batch_stats=jv["batch_stats"],
                           spectral=jv["spectral"])
    with same_widths(widths):
        # tests/test_torch_baseline_remat.py holds the remat steps to the same one
        with jax_step_lock(name):
            jstate, jld = jax_make_train_step(jm, tx)(jstate, jb, jax.random.PRNGKey(1), **FLAGS)
    tm.train()
    opt, schedule = build_optimizer(ConfigNode(jcfg.to_dict()), tm.parameters())
    state = TrainState(tm, opt)
    with same_widths(widths):
        tld, grads = port_step_keeping_grads(make_train_step(tm, opt, schedule), state, tb,
                                             torch.Generator(), **FLAGS)
    return jstate, jld, state, tld, grads


def check_step(jstate, jld, state, tld, grads: dict, keys):
    """A port step (its state after, loss dict and gradients before the
    clip) against JAX's at ``test_torch_train.py``'s tolerances."""
    assert set(tld) == set(jld) == set(keys), sorted(set(tld) ^ set(jld))
    for k, v in jld.items():
        np.testing.assert_allclose(float(tld[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(grads))
    assert state.step == int(jstate.step) == 1
    _check_state(jstate, state, lr=LR)


LOSS_KEYS = tuple(f"loss_{t}{s}" for t in ("rec", "lap", "grad") for s in ("", "_os1", "_os4", "_os8"))


def test_mgm_stacked_train_step_matches_jax():
    """``mgm_stacked`` (10 slots, 3 instances), one step: the fusion with
    random-width bands (k=30, k=15) as the loss weights, every loss term,
    the gradients before the clip, and the parameters, BatchNorm statistics
    and spectral-norm u/v after the step."""
    jb, tb = train_batch()
    check_step(*step_pair("mgm_stacked", jb, tb, [np.random.RandomState(k).randint(1, k, 10)
                                                  for k in (30, 15)]),
               LOSS_KEYS + ("total",))


def test_family_takes_remat_and_refuses_extra_slots():
    """The family's train step takes every ``model.remat`` mode
    (``tests/test_torch_baseline_remat.py`` holds the remat steps), and the
    harness refuses a train batch with more slots than
    ``encoder_args.num_mask``, naming ``dataset.train.max_inst``."""
    model = build_model(ConfigNode(jax_load_config(yaml_path("mgm")).model.to_dict()),
                        device="cpu").train()
    opt, schedule = build_optimizer(ConfigNode(jax_load_config(yaml_path("mgm")).to_dict()),
                                    model.parameters())
    for mode in ("none", "full", "selective", False, True):
        assert callable(make_train_step(model, opt, schedule, remat=mode))
    with pytest.raises(ValueError, match="must be one of"):
        make_train_step(model, opt, schedule, remat="sometimes")
    with pytest.raises(ValueError, match="dataset.train.max_inst"):
        model(train_batch(slots=10, n_i=2)[1], generator=torch.Generator())


# ---------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def him_root(tmp_path_factory):
    """Train split ``tr`` (root/tr/images, root/tr/alphas) of 2 frames with
    1-2 instances; eval split ``val`` (root/images/val, alphas and masks) of
    2 frames with 2 instances."""
    root = tmp_path_factory.mktemp("him_mgm")
    rs = np.random.RandomState(0)
    h, w = 80, 120
    png = lambda a: Image.fromarray((a * 255).astype(np.uint8))
    for i in range(2):
        (root / "tr" / "images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "tr" / "images" / f"t{i}.jpg")
        (root / "tr" / "alphas" / f"t{i}").mkdir(parents=True)
        for j in range(1 + i):
            png(blob(h, w, rs.randint(30, w - 30), rs.randint(30, h - 30), 20)).save(
                root / "tr" / "alphas" / f"t{i}" / f"{j:02d}.png")
        (root / "images" / "val").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "images" / "val" / f"v{i}.jpg")
        for j in range(2):
            a = blob(h, w, w * (j + 1) // 3, h // 2, h // 3)
            for d, arr in (("alphas", a), ("masks", (a > 0.5).astype(np.float32))):
                (root / d / "val" / f"v{i}").mkdir(parents=True, exist_ok=True)
                png(arr).save(root / d / "val" / f"v{i}" / f"{j:02d}.png")
    return str(root)


def _cli(config, *args):
    try:
        return main(["--config", yaml_path(config), "--device", "cpu", *args])
    finally:   # the CLI's log file stays open on the root logger otherwise
        for h in list(logging.getLogger().handlers):
            if isinstance(h, logging.FileHandler):
                logging.getLogger().removeHandler(h)
                h.close()


def _data_opts(root, out_dir):
    return ["name", "run", "output_dir", str(out_dir),
            "dataset.train.root_dir", root, "dataset.train.split", "tr",
            "dataset.train.short_size", "64", "dataset.train.crop", "[64, 64]",
            "dataset.test.root_dir", root, "dataset.test.split", "val",
            "dataset.test.short_size", "64", "dataset.test.mask_dir_name", "masks",
            "test.log_iter", "1"]


def test_cli_eval_only_mgm(him_root, tmp_path):
    """``main --config configs/mgm.yaml --eval-only --device cpu``: every
    metric of the yaml, finite, in ``results.csv``."""
    res = _cli("mgm", "--eval-only", *_data_opts(him_root, tmp_path))
    assert set(res) >= {"MAD", "MSE", "SAD", "Grad", "Conn"}
    assert all(np.isfinite(v) for v in res.values())
    rows = (tmp_path / "run" / "results.csv").read_text().strip().split("\n")
    assert len(rows) == 2 and rows[1].startswith("val,")


def test_cli_trains_mgm_stacked(him_root, tmp_path):
    """Two iterations of ``configs/mgm_stacked.yaml`` (AdamW, cosine) with a
    validation at the second: the losses logged, the checkpoints written."""
    state = _cli("mgm_stacked", *_data_opts(him_root, tmp_path), "train.batch_size", "2",
                 "train.max_iter", "2", "train.log_iter", "1", "train.val_iter", "2")
    assert state.step == 2
    log = (tmp_path / "run" / "log_rank0.log").read_text()
    totals = [float(v) for v in re.findall(r"Iter: \d+/2, .*?total: ([-\w.]+)", log)]
    assert len(totals) == 2 and all(np.isfinite(totals))
    for f in ("last_state.pt", "best_model.npz", "best_score.txt"):
        assert (tmp_path / "run" / f).is_file(), f
    with np.load(tmp_path / "run" / "best_model.npz") as npz:
        assert "params/encoder_mod/conv1/weight_bar" in npz.files


def test_cli_refuses_a_singinst_yaml_at_ten_slots(him_root, tmp_path):
    """``mgm.yaml`` as written (``dataset.train.max_inst`` 10, ``num_mask`` 1)
    raises at its first step, naming the key; at ``max_inst`` 1 it trains."""
    opts = (*_data_opts(him_root, tmp_path), "train.batch_size", "2", "train.max_iter", "1",
            "train.val_iter", "10")
    with pytest.raises(ValueError, match="dataset.train.max_inst"):
        _cli("mgm", *opts)
    assert _cli("mgm", *opts, "dataset.train.max_inst", "1").step == 1
