"""The port's trainer (``maggie_tpu_torch/engine/train.py``, the infeed, the
checkpoints and the CLI) on the CPU, against ``maggie_tpu`` where the two
can be held together.

The model is the flagship reduced to atten_dim 32 and final_channel 32
(``tests/test_torch_train.py``'s dims), trained through
``maggie_tpu_torch.main.main([... "--device", "cpu"])`` on a synthetic HIM set
(a train split of 4 frames, an eval split of 2) with 64x64 crops.

- The loop's flags and learning rate: the port's ``train()`` and JAX
  ``train()``, each with its train step replaced by a recorder in this file
  only, over 12 iterations across both warmup boundaries; equal flags, and
  learning rates within rtol 1e-6 (the JAX schedule is optax's f32, the
  port's f64).
- The port's first training batches equal those of the JAX ``HIMDataset`` and
  ``DataLoader`` driven directly with the same seed, bit for bit. JAX
  ``train()`` itself draws its init batch from the same dataset first
  (``maggie_tpu/engine/train.py:109-111``), in a thread of its own.
- Resume: the state the resumed run starts from equals ``last_state.pt`` bit
  for bit, and each update's generator state equals the uninterrupted run's
  at the same step; ``MAGGIE_FAULT_INJECT_ITER`` stops a fresh run only.
- ``best_model.npz`` in the JAX package's eval apply against the port's eval
  forward of the model it was saved from: within 1e-5 (the two packages sum
  convolutions in another order; ``tests/test_torch_maggie.py`` holds the
  forward at the same bound).
"""

import contextlib
import copy
import json
import logging
import os
import re
import threading

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from cv2_warp import require_cv2_float_warp
import maggie_tpu.engine.train as jax_train_mod
import maggie_tpu_torch.engine.train as port_train_mod
import maggie_tpu_torch.utils.checkpoint as port_ckpt
from maggie_tpu.config import load_config as jax_load_config
from maggie_tpu.data.him import HIMDataset as JaxHIM
from maggie_tpu.data.loader import DataLoader as JaxLoader
from maggie_tpu_torch.engine.infeed import DeviceInfeed
from maggie_tpu_torch.main import main
from test_torch_harness import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "maggie_image.yaml")
MODEL_OPTS = ["model.decoder_args.atten_dim", "32", "model.decoder_args.final_channel", "32"]
APPLY_ATOL = 1e-5


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def him_root(tmp_path_factory):
    """Train split ``tr`` (root/tr/images, root/tr/alphas) of 4 frames with 1-3
    instances; eval split ``val`` (root/images/val, alphas and masks) of 2."""
    root = tmp_path_factory.mktemp("him_trainer")
    rs = np.random.RandomState(0)
    h, w = 80, 120
    for i in range(4):
        (root / "tr" / "images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "tr" / "images" / f"t{i}.jpg")
        (root / "tr" / "alphas" / f"t{i}").mkdir(parents=True)
        for j in range(1 + i % 3):
            Image.fromarray(_blob(h, w, rs.randint(20, w - 20), rs.randint(20, h - 20),
                                  rs.randint(14, 30))).save(
                root / "tr" / "alphas" / f"t{i}" / f"{j:02d}.png")
    for i in range(2):
        (root / "images" / "val").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "images" / "val" / f"v{i}.jpg")
        for j in range(2):
            a = _blob(h, w, w * (j + 1) // 3, h // 2, h // 3)
            for d, arr in (("alphas", a), ("masks", ((a > 110) * 255).astype(np.uint8))):
                (root / d / "val" / f"v{i}").mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(root / d / "val" / f"v{i}" / f"{j:02d}.png")
    return str(root)


def _opts(root, out_dir, *extra):
    return ["name", "run", "output_dir", str(out_dir),
            "dataset.train.root_dir", root, "dataset.train.split", "tr",
            "dataset.train.short_size", "64", "dataset.train.crop", "[64, 64]",
            "dataset.test.root_dir", root, "dataset.test.split", "val",
            "dataset.test.short_size", "64", "dataset.test.mask_dir_name", "masks",
            "train.batch_size", "2", "train.log_iter", "1", "test.log_iter", "1",
            *MODEL_OPTS, *extra]


def _losses(log_path):
    text = open(log_path).read()
    return [float(v) for v in re.findall(r"Iter: \d+/\d+, .*?total: ([-\w.]+)", text)]


@contextlib.contextmanager
def _recorded_steps(rec):
    """``make_train_step`` wrapped for the runs inside: ``rec["generator"][s]``
    is the step generator's state as the update at step ``s`` starts, and
    ``rec["start"]`` the step, model and optimizer state of the first update."""
    make = port_train_mod.make_train_step

    def recording(model, optimizer, schedule):
        step = make(model, optimizer, schedule)

        def call(state, batch, generator, **kwargs):
            if "start" not in rec:
                rec["start"] = dict(step=state.step, model=copy.deepcopy(model.state_dict()),
                                    optimizer=copy.deepcopy(optimizer.state_dict()))
            rec.setdefault("generator", {})[state.step] = generator.get_state()
            return step(state, batch, generator, **kwargs)
        return call
    port_train_mod.make_train_step = recording
    try:
        yield rec
    finally:
        port_train_mod.make_train_step = make


@pytest.fixture(scope="module")
def trained(him_root, tmp_path_factory):
    """3 iterations through the CLI with ``val_iter`` 2 and ``ckpt_iter`` 3, the
    model kept where ``best_model.npz`` is written; then a resume to 4 (which
    neither validates nor saves) with the state it starts from kept, and
    ``MAGGIE_FAULT_INJECT_ITER`` 4 set; the step generator's state at each
    update of both runs."""
    out = tmp_path_factory.mktemp("trainer_out")
    best, fresh, resumed_rec = {}, {}, {}
    save_npz = port_ckpt.save_variables_npz

    def keep_best(path, model):
        best["model"] = copy.deepcopy(model).eval()
        save_npz(path, model)
    port_ckpt.save_variables_npz = keep_best
    try:
        with _recorded_steps(fresh):
            state = main(["--config", CONFIG, "--device", "cpu"]
                         + _opts(him_root, out, "train.max_iter", "3", "train.val_iter", "2",
                                 "train.ckpt_iter", "3"))
    finally:
        port_ckpt.save_variables_npz = save_npz
    run = out / "run"
    saved = torch.load(run / "last_state.pt", weights_only=True)
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGGIE_FAULT_INJECT_ITER", "4")     # fires in a fresh run only
    try:
        with _recorded_steps(resumed_rec):
            resumed = main(["--config", CONFIG, "--device", "cpu"]
                       + _opts(him_root, out, "train.max_iter", "4", "train.val_iter", "1000",
                               "train.ckpt_iter", "3", "train.resume_last", "True"))
    finally:
        mp.undo()
    return dict(run=run, state=state, best=best, saved=saved, start=resumed_rec["start"],
                resumed=resumed, generator={**fresh["generator"], **resumed_rec["generator"]})


@pytest.fixture(scope="module")
def faulted(him_root, tmp_path_factory):
    """A fresh run with ``MAGGIE_FAULT_INJECT_ITER`` 1: the updates it made
    before the fault (none) and the error."""
    rec = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("MAGGIE_FAULT_INJECT_ITER", "1")
    try:
        with _recorded_steps(rec), pytest.raises(RuntimeError) as raised:
            main(["--config", CONFIG, "--device", "cpu"]
                 + _opts(him_root, tmp_path_factory.mktemp("faulted_out"),
                         "train.max_iter", "2", "train.val_iter", "1000"))
    finally:
        mp.undo()
    return dict(steps=sorted(rec.get("generator", {})), error=str(raised.value))


def test_cli_trains_validates_and_saves(trained):
    run = trained["run"]
    for name in ("last_state.pt", "best_model.npz", "best_score.txt", "last_step.txt",
                 "best_metrics.txt", "train_meters.json", "config.yaml", "log_rank0.log"):
        assert (run / name).is_file(), name
    losses = _losses(run / "log_rank0.log")
    assert len(losses) == 4 and np.all(np.isfinite(losses))      # 3 iterations, then 1 resumed
    assert "Validation:MAD" in (run / "log_rank0.log").read_text()
    assert trained["saved"]["step"] == 3 and (run / "last_step.txt").read_text() == "3"
    meters = json.loads((run / "train_meters.json").read_text())
    assert meters["iters_measured"] == 2 and meters["batch_size"] == 2
    assert meters["samples_per_sec_sustained"] > 0 and meters["peak_mem_mb"] is None


def test_resume_starts_from_the_saved_state_bit_for_bit(trained):
    start, saved = trained["start"], trained["saved"]
    assert start["step"] == 3 and trained["resumed"].step == 4
    assert set(start["model"]) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(start["model"][k], v), k
    got, want = start["optimizer"]["state"], saved["optimizer"]["state"]
    assert set(got) == set(want) and len(want) > 0
    for i in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], want[i][k]), (i, k)


def test_fault_injection_fires_in_a_fresh_run_only(trained, faulted):
    """The injected fault stops a fresh run at its iteration, before the
    update; a resumed run skips it (``trained`` resumed with the fault at 4
    and reached step 4)."""
    assert faulted["steps"] == [] and "fault injection at iter 1" in faulted["error"]
    assert trained["resumed"].step == 4


def test_resumed_run_draws_what_an_uninterrupted_one_draws(trained, loops):
    """The step generator's state at each update depends on the step alone:
    the fresh run and its resume start each update from the state that an
    uninterrupted run of 12 iterations (``loops``) started it from."""
    whole = loops["port"]["generator"]
    assert sorted(trained["generator"]) == [0, 1, 2, 3]
    assert not torch.equal(whole[0], whole[1])
    for step, state in trained["generator"].items():
        assert torch.equal(state, whole[step]), step


def test_best_model_npz_feeds_the_jax_eval_apply(trained, him_root):
    """The port's ``best_model.npz`` as the JAX package's variables, in its
    eval apply on a val frame, against the port's eval forward of the model
    that was saved (unfolded, as validation runs it)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from maggie_tpu.models import build_model as jax_build_model
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.config import load_config

    with np.load(trained["run"] / "best_model.npz") as data:
        flat = dict(data.items())
    variables = {}
    for k, v in flat.items():
        coll, rest = k.split("/", 1)
        variables.setdefault(coll, {})[tuple(rest.split("/"))] = jnp.asarray(v)
    variables = {c: unflatten_dict(t) for c, t in variables.items()}
    assert set(variables) == {"params", "batch_stats", "spectral"}
    cfg = load_config(CONFIG, _opts(him_root, "unused"))
    sample = build_dataset(cfg, is_train=False, device="cpu")[0]
    batch = {k: sample[k][None] for k in ("image", "mask")}
    jcfg = jax_load_config(CONFIG, MODEL_OPTS)
    jmodel = jax_build_model(jcfg.model)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        pout = trained["best"]["model"]({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("refined_masks", "alpha_os8"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), atol=APPLY_ATOL,
                                   err_msg=k)


class _Counting:
    """A dataset that records which thread drew each sample."""

    def __init__(self, ds):
        self.ds, self.draws = ds, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.draws.append(threading.get_ident())
        return self.ds[i]


_ITERS = 12
_LOOP_OPTS = ("train.max_iter", str(_ITERS), "train.val_iter", "1000",
              "model.decoder_args.warmup_detail_iter", "3",
              "model.decoder_args.warmup_mask_atten_iter", "2")


@pytest.fixture(scope="module")
def loops(him_root, tmp_path_factory, monkeypatch_module):
    """Port and JAX ``train()`` with their steps replaced by recorders: the
    flags, the learning rate of each update, the batches, the samples drawn
    before the first step, and the port's step generator state."""
    import jax.numpy as jnp

    from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from maggie_tpu.engine.train_step import TrainState as JaxState

    rec = {"port": {"calls": []}, "jax": {"calls": []}}
    for side, mod in (("port", port_train_mod), ("jax", jax_train_mod)):
        orig = mod.build_dataset

        def counted(cfg, is_train, *a, _orig=orig, _side=side, **kw):
            ds = _orig(cfg, is_train, *a, **kw)
            if not is_train:
                return ds
            rec[_side]["dataset"] = _Counting(ds)
            return rec[_side]["dataset"]
        monkeypatch_module.setattr(mod, "build_dataset", counted)

    def port_make(model, optimizer, schedule):
        def step(state, batch, generator, **flags):
            r = rec["port"]
            if not r["calls"]:
                r["draws_before_step"] = list(r["dataset"].draws)
            r["calls"].append(dict(flags, lr=schedule(state.step),
                                   batch={k: v.numpy().copy() for k, v in batch.items()}))
            r.setdefault("generator", {})[state.step] = generator.get_state()
            state.step += 1
            return {"total": torch.zeros(())}
        return step
    monkeypatch_module.setattr(port_train_mod, "make_train_step", port_make)

    def jax_make(model, tx, remat=False):
        def step(state, batch, rng, **flags):
            r = rec["jax"]
            if not r["calls"]:
                r["draws_before_step"] = list(r["dataset"].draws)
            r["calls"].append(dict(flags, step=int(state.step)))
            return state.replace(step=state.step + 1), {"total": jnp.zeros(())}
        return step
    monkeypatch_module.setattr(jax_train_mod, "make_train_step", jax_make)
    monkeypatch_module.setattr(jax_train_mod, "create_train_state",
                               lambda model, tx, batch, rng: JaxState(
                                   step=jnp.zeros((), jnp.int32), params={}, opt_state=None,
                                   batch_stats={}, spectral={}))

    out = tmp_path_factory.mktemp("loops")
    port_cfg_args = ["--config", CONFIG, "--device", "cpu"] + _opts(him_root, out / "p", *_LOOP_OPTS)
    main(port_cfg_args)
    jcfg = jax_load_config(CONFIG, _opts(him_root, out / "j", *_LOOP_OPTS))
    jcfg.output_dir = str(out / "j")
    jax_train_mod.train(jcfg, use_wandb=False)
    _, schedule = jax_build_optimizer(jcfg)
    for c in rec["jax"]["calls"]:
        c["lr"] = float(schedule(c.pop("step")))
    return rec


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_loop_flags_and_lr_equal_jax(loops):
    port, ref = loops["port"]["calls"], loops["jax"]["calls"]
    assert len(port) == len(ref) == _ITERS
    keys = ("use_mask_atten", "use_gt_guidance", "use_prm_weights", "atten_loss_enabled")
    assert [{k: c[k] for k in keys} for c in port] == [{k: c[k] for k in keys} for c in ref]
    np.testing.assert_allclose([c["lr"] for c in port], [c["lr"] for c in ref], rtol=1e-6)
    # both warmup boundaries fall inside the 12 iterations
    assert port[0]["use_mask_atten"] and not port[-1]["use_mask_atten"]
    assert port[0]["use_gt_guidance"] and port[1]["use_gt_guidance"]
    assert not all(c["use_gt_guidance"] for c in port[9:])


def test_first_batches_equal_the_jax_dataset_and_loader(loops, him_root, monkeypatch):
    """The port trainer's batches against JAX's ``HIMDataset`` + ``DataLoader``
    driven directly with the trainer's seed and options (where the samples
    went through the warp, cv2 must be the build that the port replicates)."""
    cfg = jax_load_config(CONFIG, _opts(him_root, "unused"))
    seed = cfg.train.seed
    ds = JaxHIM(cfg.dataset.train.root_dir, cfg.dataset.train.split, is_train=True,
                random_seed=seed, **{k: v for k, v in cfg.dataset.train.items()
                                     if k not in ("name", "root_dir", "split")})
    ref = iter(JaxLoader(ds, batch_size=2, shuffle=True, drop_last=True, seed=seed,
                         infinite=True))
    warps, warp = [], cv2.warpAffine

    def counted(*args, **kwargs):
        warps.append(1)
        return warp(*args, **kwargs)
    monkeypatch.setattr(cv2, "warpAffine", counted)
    wants = [next(ref) for _ in range(3)]
    if warps:
        require_cv2_float_warp()
    for call, want in zip(loops["port"]["calls"][:3], wants):
        for k in ("image", "mask", "alpha", "transition"):
            np.testing.assert_array_equal(call["batch"][k], want[k], err_msg=k)


def test_jax_train_draws_an_init_batch_first_and_the_port_none(loops):
    """A JAX-side hazard: ``train()`` takes its init batch through a second
    loader on the training set; that loader's thread draws 1 to 4 samples
    from the set's shared ``RandomState`` (its first batch, its prefetch queue
    of 2, one more it blocks on) before the first step. The port draws only
    through its training loader."""
    jax_draws = loops["jax"]["draws_before_step"]
    threads = list(dict.fromkeys(jax_draws))
    assert len(threads) == 2                    # the init loader's, then the train loader's
    assert 1 <= jax_draws.count(threads[0]) <= 4
    assert jax_draws[0] == threads[0]
    port_draws = loops["port"]["draws_before_step"]
    assert len(set(port_draws)) == 1 and len(port_draws) >= 2


def test_infeed_on_the_cpu():
    batches = [{"image": np.full((1, 1, 4, 4, 3), i, np.float32),
                "mask": np.zeros((1, 1, 2, 1, 1), np.float32), "other": i} for i in range(3)]
    feed = DeviceInfeed(iter(batches), torch.device("cpu"))
    got = list(feed)
    assert [b["other"] for b, _ in got] == [0, 1, 2]
    for i, (_, dev) in enumerate(got):
        assert set(dev) == {"image", "mask"} and dev["image"].device.type == "cpu"
        assert torch.equal(dev["image"], torch.full((1, 1, 4, 4, 3), float(i)))
    feed.close()
    assert not feed._thread.is_alive()

    def broken():
        yield batches[0]
        raise ValueError("bad batch")
    feed = DeviceInfeed(broken(), torch.device("cpu"))
    next(feed)
    for _ in range(2):                          # raised again on every later next()
        with pytest.raises(ValueError, match="bad batch"):
            next(feed)
    feed.close()

    def endless():
        while True:
            yield batches[1]
    feed = DeviceInfeed(endless(), torch.device("cpu"), depth=2)
    next(feed)
    feed.close()
    assert not feed._thread.is_alive() and feed._q.empty()


def test_partial_load_copies_matching_keys_and_logs_the_rest(caplog):
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.utils.convert_jax import to_jax
    cfg = load_config(CONFIG, MODEL_OPTS)
    src = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(1))
    dst = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(2))
    flat = to_jax(dict(src.named_parameters()))
    gone = "params/aspp_mod/conv2/weight"
    bad = "params/aspp_mod/bn2/bn/bias"
    assert gone in flat and bad in flat
    del flat[gone]
    flat[bad] = np.zeros(3, np.float32)
    flat["params/nowhere/kernel"] = np.ones(2, np.float32)
    flat["batch_stats/aspp_mod/bn2/mean"] = np.ones(2, np.float32)     # not a parameter
    before = {k: v.clone() for k, v in dst.named_parameters()}
    with caplog.at_level(logging.WARNING):
        missing, unexpected, mismatched = port_ckpt.partial_load(dst, flat)
    assert missing == [gone]
    assert unexpected == ["params/nowhere/kernel"]
    assert [m[0] for m in mismatched] == [bad]
    assert "Missing keys (1)" in caplog.text and "Shape-mismatched" in caplog.text
    src_p = dict(src.named_parameters())
    for k, v in dst.named_parameters():
        if k in ("aspp.conv2.weight", "aspp.bn2.bias"):
            assert torch.equal(v, before[k]), k
        else:
            assert torch.equal(v, src_p[k]), k


def test_main_refuses_remat(him_root, tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        main(["--config", CONFIG, "--device", "cpu"]
             + _opts(him_root, tmp_path, "model.remat", "selective"))


def test_closing_the_infeed_stops_the_loader_thread():
    """``close()`` also closes the loader's iterator, whose thread then stops
    after the batch it is making: an endless loader leaves no thread behind."""
    from maggie_tpu_torch.data.loader import DataLoader

    class Slow:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            threading.Event().wait(0.01)
            return {"image": np.full((1, 2, 2, 3), i, np.float32)}
    before = threading.active_count()
    feed = DeviceInfeed(iter(DataLoader(Slow(), batch_size=2, shuffle=True, infinite=True)),
                        torch.device("cpu"))
    next(feed)
    feed.close()
    deadline = threading.Event()
    for _ in range(50):
        if threading.active_count() == before:
            break
        deadline.wait(0.02)
    assert threading.active_count() == before


def test_train_visualization_panel(tmp_path):
    """``engine/vis.py`` without cv2: one row per instance (at most 4) of
    image | mask (nearest-upsampled from 1/8) | alpha | prediction | transition."""
    from maggie_tpu_torch.engine.vis import save_train_visualization
    rs = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rs.randn(2, 1, 16, 24, 3).astype(np.float32)),
             "mask": torch.from_numpy((rs.rand(2, 1, 5, 2, 3) > 0.5).astype(np.float32)),
             "alpha": torch.from_numpy(rs.rand(2, 1, 5, 16, 24).astype(np.float32)),
             "transition": torch.from_numpy((rs.rand(2, 1, 5, 16, 24) > 0.5).astype(np.float32))}
    out = {"refined_masks": torch.from_numpy(rs.rand(2, 1, 5, 16, 24).astype(np.float32))}
    path = save_train_visualization(batch, out, 7, str(tmp_path))
    assert path.endswith("iter_0000007.png")
    panel = np.asarray(Image.open(path))
    assert panel.shape == (4 * 16, 5 * 24, 3)
    np.testing.assert_array_equal(panel[:16, 24:32, 0] // 255,
                                  batch["mask"][0, 0, 0].numpy().repeat(8, 0).repeat(8, 1)[:, :8])
