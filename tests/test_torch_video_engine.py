"""The port's video eval engine against ``maggie_tpu``'s on the CPU: the VIM
eval set sample by sample, ``test()`` on a VIM set (``eval_video``, the
streaming windows with the feature cache), and the CLI's ``--eval-only`` on
``configs/maggie_video.yaml``; ``test_torch_video_memory.py`` runs ``test()``
with the memory carried (each JAX ``test()`` compiles its programs anew, so
the two runs sit in two files that test workers take in parallel).

The set holds two videos of six frames at different sizes (96x128 and 88x120,
both 64x128 after ``ResizeShort(64)`` and the pad), two instances that move a
few pixels a frame. The model is ``test_torch_video.py``'s reduced one, set
through the yaml's overrides, with weights chosen as the ``weights``
fixture says. JAX runs without
shape bucketing (the port runs each clip at its own shape); every metric is
held within rtol 1e-4, the image engine's gate (``test_torch_engine.py``).
"""

import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

import maggie_tpu.engine.test as jax_engine
import maggie_tpu_torch.engine.test as port_engine
from maggie_tpu.config import load_config as jax_load_config
from maggie_tpu.data.vim import VIMDataset as JaxVIM
from maggie_tpu_torch.config import load_config
from maggie_tpu_torch.data.vim import VIMDataset
from maggie_tpu_torch.main import main
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.utils.convert_jax import to_jax
from test_torch_harness import jax_variables, one_torch_thread, port_from_flat, random_flat  # noqa: F401
from test_torch_video import assert_margins, threshold_margins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "maggie_video.yaml")
RTOL = 1e-4
METRICS = ["MAD", "MSE", "SAD", "Grad", "Conn", "dtSSD", "MESSDdt"]
# test_torch_video.py's reduced model as overrides of the yaml
MODEL_OPTS = ["model.encoder_args.num_mask", "3", "model.decoder_args.atten_dim", "32",
              "model.decoder_args.final_channel", "32", "model.decoder_args.max_inst", "3",
              "model.decoder_args.atten_block", "1"]


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def vim_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("vim_gate")
    rs = np.random.RandomState(0)
    split = root / "medium"
    for vid, (h, w) in (("vid0", (96, 128)), ("vid1", (88, 120))):
        (split / "fgr" / vid).mkdir(parents=True)
        for t in range(6):
            Image.fromarray(rs.randint(0, 255, (h, w, 3), np.uint8)).save(
                split / "fgr" / vid / f"{t:04d}.jpg")
            for j in range(2):
                a = _blob(h, w, 30 + 50 * j + 2 * t, h // 2, h // 4)
                for d, arr in (("pha", a), ("xmem", ((a > 127) * 255).astype(np.uint8))):
                    (split / d / vid / f"{t:04d}").mkdir(parents=True, exist_ok=True)
                    Image.fromarray(arr).save(split / d / vid / f"{t:04d}" / f"{j:02d}.png")
    return str(root)


def _opts(root, extra=()):
    return (["dataset.test.root_dir", root, "dataset.test.split", "medium",
             "dataset.test.short_size", "64", "test.log_iter", "1",
             "test.shape_bucketing", "False"]
            + MODEL_OPTS + list(extra))


@pytest.mark.parametrize("mask_dir", ["xmem", ""])
def test_vim_samples_equal_jax(vim_root, mask_dir):
    """Every clip: arrays, names, flags and transform_info; without a mask dir
    the masks come from the alphas (binarized, then an 8x down-up resample)."""
    kw = dict(root_dir=vim_root, split="medium", clip_length=3, clip_overlap=2,
              is_train=False, short_size=64, alpha_dir_name="pha", mask_dir_name=mask_dir)
    port, ref = VIMDataset(**kw), JaxVIM(**kw)
    assert len(port) == len(ref) == 8 and port.frame_ids == ref.frame_ids
    for i in range(len(ref)):
        a, b = port[i], ref[i]
        assert set(a) == set(b), i
        for k in ("image", "mask", "alpha", "trimap"):
            assert a[k].dtype == b[k].dtype, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"clip {i} {k}")
        for k in ("image_names", "transform_info", "skip", "is_first", "is_last"):
            assert a[k] == b[k], (i, k)
    assert [port[i]["skip"] for i in range(4)] == [0, 2, 2, 2]
    assert [port[i]["is_last"] for i in range(4)] == [0, 0, 0, 1]


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, flat) of the reduced video model, seed 19 over the
    variable tree in sorted order: of seeds 0-39, one of four whose windows
    keep ``test_torch_video.MARGINS`` from every discrete threshold with the
    memory carried and not, and the one among them where the os8 alpha
    passes 0.95, the box cuts the map and the rule's candidates differ. The
    tree's keys and shapes come from the port's model through ``to_jax``
    (test_torch_video.py holds them to JAX's own tree)."""
    cfg = load_config(CONFIG, MODEL_OPTS)
    shapes = {k: v.shape for k, v in to_jax(build_model(cfg.model, device="cpu")
                                            .state_dict()).items()}
    flat = random_flat(dict(sorted(shapes.items())), seed=19)
    return jax_variables(flat), flat


def _spy(module, calls):
    """Record every window's metric dict (what the engine logs)."""
    orig = module.compute_metrics

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(dict(out))
        return out
    module.compute_metrics = spy
    return orig


def run_both(vim_root, weights, out_dir, carry_memory: bool) -> dict:
    """JAX ``test()`` and the port's on the set: the results, each window's
    metrics (what the engines log) and the port's threshold margins."""
    jv, flat = weights
    extra = ["test.carry_memory", str(carry_memory), "name", "gate", "output_dir", out_dir]
    jcfg = jax_load_config(CONFIG, _opts(vim_root, extra))
    pcfg = load_config(CONFIG, _opts(vim_root, extra))
    calls = {"jax": [], "port": []}
    orig = {"jax": _spy(jax_engine, calls["jax"]), "port": _spy(port_engine, calls["port"])}
    try:
        jres = jax_engine.test(jcfg, variables=jv)
        with threshold_margins() as margins:
            pres = port_engine.test(pcfg, model=port_from_flat(pcfg.model, flat))
    finally:
        jax_engine.compute_metrics = orig["jax"]
        port_engine.compute_metrics = orig["port"]
    return dict(jres=jres, pres=pres, calls=calls, margins=margins)


def assert_runs_match(run: dict) -> None:
    jres, pres, calls = run["jres"], run["pres"], run["calls"]
    # no window lies near a discrete threshold (test_torch_video.py): with
    # seed 10 in another order one os8 alpha lay at 0.95 exactly, and a snap
    # that differed on rounding moved dtSSD and MESSDdt by 1e-3
    assert_margins(run["margins"], 8)
    assert list(pres) == list(jres) == METRICS + ["MAD_fg", "MAD_bg", "MAD_unk"]
    assert len(calls["port"]) == len(calls["jax"]) == 8
    # the temporal metrics start at each video's second window
    assert [("MESSDdt" in c) for c in calls["port"]] == [False, True, True, True] * 2
    for k in jres:
        assert np.isfinite(pres[k]), k
        np.testing.assert_allclose(pres[k], jres[k], rtol=RTOL, err_msg=k)
    for i, (p, j) in enumerate(zip(calls["port"], calls["jax"])):
        assert list(p) == list(j), i
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=f"window {i} {k}")


def test_port_test_matches_jax(vim_root, weights, tmp_path):
    """With fresh memory in every window (``test.carry_memory`` off, the
    default); ``test_torch_video_memory.py`` carries it."""
    assert_runs_match(run_both(vim_root, weights, str(tmp_path), False))


def test_cli_eval_only_writes_results_csv(vim_root, weights, tmp_path):
    """``maggie_tpu_torch.main.main(["--config", "configs/maggie_video.yaml",
    "--eval-only", "--device", "cpu", ...])`` on a .pth of the reduced model:
    its log and ``results.csv`` with the seven metrics and the trimap regions."""
    _, flat = weights
    cfg = load_config(CONFIG, MODEL_OPTS)
    pth = tmp_path / "video_reduced.pth"
    torch.save(port_from_flat(cfg.model, flat).state_dict(), pth)
    out_dir = tmp_path / "out"
    try:
        main(["--config", CONFIG, "--eval-only", "--device", "cpu", "name", "vgate",
              "output_dir", str(out_dir), "model.weights", str(pth)]
             + _opts(vim_root, ["test.log_iter", "10"]))
    finally:   # the CLI's log file stays open on the root logger otherwise
        for h in list(logging.getLogger().handlers):
            if isinstance(h, logging.FileHandler):
                logging.getLogger().removeHandler(h)
                h.close()
    assert (out_dir / "vgate" / "test-log_rank0.log").is_file()
    rows = (out_dir / "vgate" / "results.csv").read_text().strip().split("\n")
    assert rows[0] == "split,masks," + ",".join(METRICS + ["MAD_fg", "MAD_bg", "MAD_unk"])
    assert len(rows) == 2
    cells = rows[1].split(",")
    assert cells[:2] == ["medium", "xmem"]
    assert all(np.isfinite(float(c)) for c in cells[2:])
