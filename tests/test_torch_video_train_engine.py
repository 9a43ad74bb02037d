"""The port's video trainer through its CLI on the CPU: ``python -m
maggie_tpu_torch.main --config configs/maggie_video.yaml --device cpu ...``
trains ``MaGGIe_Temp`` on a synthetic VIM train set (clips of 3 frames, 64x64
crops) and validates through ``eval_video`` on a VIM test split.

The model is the video config reduced to the CPU tests' dims (atten_dim 32,
final_channel 32, 3 slots, one attention block; ``tests/test_video_e2e.py``).

- Two iterations, validation at the second through ``eval_video`` (not
  ``eval_image``), the temporal losses in the log, the checkpoint files.
- A resume to iteration 3 starts from ``last_state.pt`` bit for bit.
- ``best_model.npz`` in the JAX package's video eval apply on a val window
  against the port's eval forward of the model that was saved, within 1e-5
  (``tests/test_torch_train_engine.py``'s bound for the image model) on the
  change maps, which no threshold decides, and on the alphas. The alphas
  pass the four discrete thresholds of ``tests/test_torch_video.py``, and
  after two steps from a seeded init the change maps hug 0.5: the window's
  values lie 1.4e-6 from it at the closest, under that file's margins, so
  the two packages' rounding could flip a pixel. None flips with this data
  (the alphas agree within 1.5e-6, refined_masks 1.5e-7); a flip would
  move a pixel by up to 1 and fail here, not pass. The video model has no
  parameter, statistic or u/v beyond those the eval path already converts.
"""

import copy
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import maggie_tpu_torch.engine.train as port_train_mod
import maggie_tpu_torch.utils.checkpoint as port_ckpt
from maggie_tpu_torch.main import main
from test_torch_harness import one_torch_thread  # noqa: F401
from test_torch_train_engine import _recorded_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "maggie_video.yaml")
MODEL_OPTS = ["model.encoder_args.num_mask", "3", "model.decoder_args.max_inst", "3",
              "model.decoder_args.atten_dim", "32", "model.decoder_args.final_channel", "32",
              "model.decoder_args.atten_block", "1"]
APPLY_ATOL = 1e-5


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def vim_root(tmp_path_factory):
    """root/tr: 2 videos of 6 frames at 72x96 with 3 blobs moving 2 px a frame
    (fgr/ and pha/); root/val: 1 video of 4 frames, its xmem masks the alphas
    binarized."""
    root = tmp_path_factory.mktemp("vim_trainer")
    h, w = 72, 96
    for split, videos, n_f in (("tr", 2, 6), ("val", 1, 4)):
        rs = np.random.RandomState(1 if split == "val" else 0)
        for v in range(videos):
            blobs = [(rs.randint(20, w - 20), rs.randint(20, h - 20), rs.randint(12, 20))
                     for _ in range(3)]
            for t in range(n_f):
                fdir = root / split / "fgr" / f"v{v}"
                fdir.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
                    fdir / f"{t:04d}.jpg")
                for j, (cx, cy, r) in enumerate(blobs):
                    a = _blob(h, w, cx + 2 * t, cy + t, r)
                    dirs = (("pha", a), ("xmem", ((a > 127) * 255).astype(np.uint8)))
                    for d, arr in dirs[:2 if split == "val" else 1]:
                        adir = root / split / d / f"v{v}" / f"{t:04d}"
                        adir.mkdir(parents=True, exist_ok=True)
                        Image.fromarray(arr).save(adir / f"{j:02d}.png")
    return str(root)


def _opts(root, out_dir, *extra):
    return ["name", "run", "output_dir", str(out_dir),
            "dataset.train.root_dir", root, "dataset.train.split", "tr",
            "dataset.train.short_size", "64", "dataset.train.crop", "[64, 64]",
            "dataset.train.clip_length", "3", "dataset.train.max_inst", "3",
            "dataset.test.root_dir", root, "dataset.test.split", "val",
            "dataset.test.short_size", "64", "train.batch_size", "1", "train.log_iter", "1",
            "test.log_iter", "1", "train.val_metrics", "['MAD', 'dtSSD']",
            *MODEL_OPTS, *extra]


@pytest.fixture(scope="module")
def trained(vim_root, tmp_path_factory):
    """2 iterations through the CLI, validating at the second, with the
    validations counted by kind and the model kept where ``best_model.npz``
    is written; then a resume to 3 with the state it starts from kept."""
    out = tmp_path_factory.mktemp("video_trainer_out")
    best, fresh, resumed_rec, vals = {}, {}, {}, []
    save_npz = port_ckpt.save_variables_npz
    evaluate = {k: getattr(port_train_mod, k) for k in ("eval_image", "eval_video")}

    def keep_best(path, model):
        best["model"] = copy.deepcopy(model).eval()
        save_npz(path, model)

    def counted(kind):
        def call(*a, **kw):
            vals.append(kind)
            return evaluate[kind](*a, **kw)
        return call
    mp = pytest.MonkeyPatch()
    mp.setattr(port_ckpt, "save_variables_npz", keep_best)
    for kind in evaluate:
        mp.setattr(port_train_mod, kind, counted(kind))
    try:
        with _recorded_steps(fresh):
            state = main(["--config", CONFIG, "--device", "cpu"]
                         + _opts(vim_root, out, "train.max_iter", "2", "train.val_iter", "2"))
        saved = torch.load(out / "run" / "last_state.pt", weights_only=True)
        with _recorded_steps(resumed_rec):
            resumed = main(["--config", CONFIG, "--device", "cpu"]
                           + _opts(vim_root, out, "train.max_iter", "3", "train.val_iter", "1000",
                                   "train.resume_last", "True"))
    finally:
        mp.undo()
    return dict(run=out / "run", state=state, best=best, saved=saved, vals=vals,
                start=resumed_rec["start"], resumed=resumed)


def test_cli_trains_and_validates_through_eval_video(trained):
    run = trained["run"]
    for name in ("last_state.pt", "best_model.npz", "best_score.txt", "last_step.txt",
                 "best_metrics.txt", "train_meters.json", "config.yaml", "log_rank0.log"):
        assert (run / name).is_file(), name
    assert trained["vals"] == ["eval_video"]
    log = (run / "log_rank0.log").read_text()
    lines = re.findall(r"Iter: \d+/\d+, .*", log)
    assert len(lines) == 3
    for line in lines:
        for k in ("total", "loss_temp", "loss_temp_bce", "loss_temp_dtssd", "loss_dtSSD"):
            v = re.search(rf", {k}: ([-\w.]+)", line)
            assert v and np.isfinite(float(v[1])), (k, line)
    assert re.search(r"Validation:MAD: [\d.]+, dtSSD: [\d.]+", log)
    assert trained["saved"]["step"] == 2 and trained["resumed"].step == 3


def test_resume_starts_from_the_saved_state_bit_for_bit(trained):
    start, saved = trained["start"], trained["saved"]
    assert start["step"] == 2
    assert set(start["model"]) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(start["model"][k], v), k
    got, want = start["optimizer"]["state"], saved["optimizer"]["state"]
    assert set(got) == set(want) and len(want) > 0
    for i in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[i][k], want[i][k]), (i, k)


def test_best_model_npz_feeds_the_jax_video_eval_apply(trained, vim_root):
    """The port's ``best_model.npz`` as the JAX package's variables, in its
    video eval apply on the first val window, against the port's eval forward
    of the model that was saved (unfolded, as validation runs it)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from maggie_tpu.config import load_config as jax_load_config
    from maggie_tpu.models import build_model as jax_build_model
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.utils.convert_jax import to_jax

    with np.load(trained["run"] / "best_model.npz") as data:
        flat = dict(data.items())
    assert set(flat) == set(to_jax(trained["best"]["model"].state_dict()))
    variables = {}
    for k, v in flat.items():
        coll, rest = k.split("/", 1)
        variables.setdefault(coll, {})[tuple(rest.split("/"))] = jnp.asarray(v)
    variables = {c: unflatten_dict(t) for c, t in variables.items()}
    assert set(variables) == {"params", "batch_stats", "spectral"}
    cfg = load_config(CONFIG, _opts(vim_root, "unused"))
    sample = build_dataset(cfg, is_train=False, device="cpu")[0]
    batch = {k: sample[k][None] for k in ("image", "mask")}
    jmodel = jax_build_model(jax_load_config(CONFIG, MODEL_OPTS).model)
    jout = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        pout = trained["best"]["model"]({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("diff_pred_forward", "diff_pred_backward"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=APPLY_ATOL, err_msg=k)
    for k in ("refined_masks", "alpha_os8", "temp_alpha"):
        np.testing.assert_allclose(pout[k].numpy(), np.asarray(jout[k]), rtol=0,
                                   atol=APPLY_ATOL, err_msg=k)
