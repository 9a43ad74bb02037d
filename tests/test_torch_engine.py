"""The engine gate: the port's ``test()`` against ``maggie_tpu``'s on one
synthetic HIM set and one set of weights, then the port's CLI through
``tools/extract_results.py``.

The model is the harness's reduced flagship (``tests/test_torch_harness.py``).
JAX ``test(cfg, variables=...)`` runs with ``test.shape_bucketing False`` (the
port runs each sample at its own shape) and is handed the harness variables,
so the JAX package's spectral-norm fold, wrong for the decoder's transposed
convs (ROADMAP queue 3), never runs. The set's three images share one padded
shape, so JAX compiles once.

Tolerances: every averaged metric and every per-batch metric value within
rtol 1e-4 of the JAX package's (the alphas differ by float rounding, a few
1e-6, and a pixel that crosses the 1/255 or 254/255 clamp moves a metric by
about 1/255 of one pixel's share). The CLI's ``results.csv`` holds the port's
``test()`` values within rtol 1e-6 (the same model and data in another
process; the log prints each value's repr).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import maggie_tpu.engine.test as jax_engine
import maggie_tpu_torch.engine.test as port_engine
from maggie_tpu.config import load_config as jax_load_config
from maggie_tpu_torch.config import load_config
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.utils.convert_jax import convert_jax
from test_torch_harness import ATTEN, FINAL, build_pair, jax_cfg, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "maggie_image.yaml")
MASK_DIR = "masks_matched_r50_fpn_3x"
RTOL = 1e-4
# the reduced model as CLI overrides of configs/maggie_image.yaml
MODEL_OPTS = ["model.decoder_args.atten_dim", str(ATTEN),
              "model.decoder_args.final_channel", str(FINAL)]


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


def _opts(root):
    return ["dataset.test.root_dir", root, "dataset.test.split", "natural",
            "dataset.test.short_size", "64", "dataset.test.mask_dir_name", MASK_DIR,
            "test.log_iter", "1", "test.shape_bucketing", "False"]


@pytest.fixture(scope="module")
def him_root(tmp_path_factory):
    """Three images that all become 64x85, padded to 64x128: one downscaled
    by 2/3, one by 8/15, one already at the short size; two instances each."""
    root = tmp_path_factory.mktemp("him_gate")
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate([(96, 128), (120, 160), (64, 85)]):
        (root / "images" / "natural").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (h, w, 3), np.uint8)).save(
            root / "images" / "natural" / f"img{i}.jpg")
        for j in range(2):
            a = _blob(h, w, w * (j + 1) // 3, h // 2, h // 3)
            for d, arr in (("alphas", a), (MASK_DIR, ((a > 110) * 255).astype(np.uint8))):
                (root / d / "natural" / f"img{i}").mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(root / d / "natural" / f"img{i}" / f"{j:02d}.png")
    return str(root)


def _port_cfg(root, extra=()):
    return load_config(CONFIG, _opts(root) + MODEL_OPTS + list(extra))


def _spy(module, calls):
    """Record every per-batch metric dict the engine computes (what it logs)."""
    orig = module.compute_metrics

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(dict(out))
        return out
    module.compute_metrics = spy
    return orig


@pytest.fixture(scope="module")
def runs(him_root):
    jm, jv, tm, flat = build_pair()
    jcfg = jax_load_config(CONFIG, _opts(him_root))
    jcfg.model = jax_cfg().model
    pcfg = _port_cfg(him_root)
    calls = {"jax": [], "port": []}
    orig = {"jax": _spy(jax_engine, calls["jax"]), "port": _spy(port_engine, calls["port"])}
    try:
        jres = jax_engine.test(jcfg, variables=jv)
        pres = port_engine.test(pcfg, model=tm)
    finally:
        jax_engine.compute_metrics = orig["jax"]
        port_engine.compute_metrics = orig["port"]
    return dict(jres=jres, pres=pres, calls=calls, tm=tm, jv=jv, flat=flat, pcfg=pcfg)


def _near_thresholds(alpha, eps=1e-5):
    edges = [1 / 255, 254 / 255] + [round(0.1 * i, 1) for i in range(11)]
    return {e: int((np.abs(alpha - e) < eps).sum()) for e in edges}


def test_port_test_matches_jax(runs):
    jres, pres, calls = runs["jres"], runs["pres"], runs["calls"]
    assert list(pres) == list(jres) == ["MAD", "MSE", "SAD", "Grad", "Conn",
                                        "MAD_fg", "MAD_bg", "MAD_unk"]
    assert len(calls["port"]) == len(calls["jax"]) == 3
    try:
        for k in jres:
            np.testing.assert_allclose(pres[k], jres[k], rtol=RTOL, err_msg=k)
        for i, (p, j) in enumerate(zip(calls["port"], calls["jax"])):
            assert list(p) == list(j)
            for k in j:
                np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=f"batch {i} {k}")
    except AssertionError as err:
        # which alphas could flip a clamp or a Conn threshold on float rounding
        ds = port_engine.build_dataset(runs["pcfg"], is_train=False, device="cpu")
        near = []
        with torch.inference_mode():
            for s in (ds[i] for i in range(len(ds))):
                out = runs["tm"]({"image": torch.from_numpy(s["image"][None]),
                                  "mask": torch.from_numpy(s["mask"][None])})
                near.append(_near_thresholds(out["refined_masks"].numpy()))
        raise AssertionError(f"{err}\nalpha pixels within 1e-5 of each threshold: {near}")


def test_cli_eval_only_writes_results_csv(runs, him_root, tmp_path):
    """``python -m maggie_tpu_torch.main --eval-only --device cpu`` on a .pth
    of the same model, then ``tools/extract_results.py`` on its log."""
    pth = tmp_path / "maggie_reduced.pth"
    torch.save(runs["tm"].state_dict(), pth)
    out_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "maggie_tpu_torch.main", "--config", CONFIG, "--eval-only",
           "--device", "cpu", "name", "gate", "output_dir", str(out_dir),
           "model.weights", str(pth), "test.log_iter", "10"] + _opts(him_root)[:-4] + MODEL_OPTS
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    log = out_dir / "gate" / "test-log_rank0.log"
    r = subprocess.run([sys.executable, "tools/extract_results.py", str(log), str(out_dir)],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    rows = (out_dir / "results.csv").read_text().strip().split("\n")
    assert rows[0] == "split,masks,MAD,MAD_fg,MAD_unk,MSE,SAD,Grad,Conn"
    assert len(rows) == 2
    cells = rows[1].split(",")
    assert cells[:2] == ["natural", "r50_fpn_3x"]
    want = [runs["pres"][k] for k in ("MAD", "MAD_fg", "MAD_unk", "MSE", "SAD", "Grad", "Conn")]
    np.testing.assert_allclose([float(c) for c in cells[2:]], want, rtol=1e-6)


def test_npz_weights_load_what_convert_jax_gives(runs, tmp_path):
    from maggie_tpu.utils.checkpoint import save_variables_npz
    from maggie_tpu_torch.utils.checkpoint import load_model_weights
    path = str(tmp_path / "variables.npz")
    save_variables_npz(path, runs["jv"])
    cfg = load_config(None, ["model.weights", path])
    cfg.model = runs["pcfg"].model.clone()
    cfg.model.weights = path
    model = load_model_weights(build_model(cfg.model, device="cpu"), cfg)
    want = convert_jax(runs["flat"], build_model(cfg.model, device="cpu"))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_from_pretrained_loads_and_folds(runs, tmp_path):
    """A checkpoint laid out as a released one: the ``state_dict`` under a
    ``state_dict`` key, with the reference's unused index-book weights."""
    from maggie_tpu_torch.flagship import blob_batch
    from maggie_tpu_torch.pretrained import from_pretrained
    pth = str(tmp_path / "w.pth")
    sd = dict(runs["tm"].state_dict())
    sd["decoder.dummy_downscale.0.weight"] = torch.zeros(32, 3, 3, 3)
    torch.save({"state_dict": sd}, pth)
    model, cfg = from_pretrained(pth, config=runs["pcfg"], overrides={"test.log_iter": 7},
                                 device="cpu")
    assert cfg.model.weights == pth and cfg.test.log_iter == 7
    assert not hasattr(model.encoder.conv1.module, "weight_u")
    batch = blob_batch(64, 128, 2, seed=1)
    with torch.inference_mode():
        got, want = model(batch), runs["tm"](batch)
    for k in want:   # folding divides the weights once by the sigma the unfolded model uses
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind,match", [("safetensors", "not a safetensors file"),
                                        ("orbax_dir", "not ported"), ("hub_id", "not ported"),
                                        ("missing_pth", "no such file")])
def test_weights_that_cannot_load_raise(runs, tmp_path, kind, match):
    """An empty ``.safetensors`` file, an orbax dir, a hub id, a missing file."""
    from maggie_tpu_torch.utils.checkpoint import load_model_weights
    exc = FileNotFoundError
    if kind == "safetensors":
        weights = str(tmp_path / "model.safetensors")
        open(weights, "wb").close()
        exc = ValueError
    elif kind == "orbax_dir":
        weights = str(tmp_path)
    elif kind == "hub_id":
        weights = "chuonghm/maggie-image-him50k-cvpr24"
    else:
        weights = str(tmp_path / "absent.pth")
    cfg = runs["pcfg"].clone()
    cfg.model.weights = weights
    with pytest.raises(exc, match=match):
        load_model_weights(build_model(cfg.model, device="cpu"), cfg)


def test_entry_points_run_on_cuda_unless_asked(him_root):
    """Without a GPU, each entry point raises unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    from maggie_tpu_torch.main import main
    from maggie_tpu_torch.pretrained import from_pretrained
    cfg = _port_cfg(him_root)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_engine.test(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_pretrained("", config=cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", CONFIG])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--config", os.path.join(REPO, "configs", "maggie_video.yaml"), "--eval-only"])


def test_dummy_forward_matches_jax():
    """Arch ``Dummy``: the masks resized nearest to the frame, as
    ``refined_masks`` and ``alpha_os8``, and a zero train loss, equal to the
    JAX package's bit for bit."""
    import jax
    import jax.numpy as jnp
    from maggie_tpu.models import build_model as jax_build_model
    jcfg = jax_load_config(None)
    jcfg.model.arch = "Dummy"
    rs = np.random.RandomState(0)
    batch = {"image": rs.rand(2, 2, 40, 56, 3).astype(np.float32),
             "mask": (rs.rand(2, 2, 3, 5, 7) > 0.5).astype(np.float32)}
    jm = jax_build_model(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv = jm.init({"params": jax.random.PRNGKey(0)}, jb)
    model = build_model(load_config(None, ["model.arch", "Dummy"]).model, device="cpu")
    assert list(model.state_dict()) == ["scale"] and float(model.scale.detach()) == 0.0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jm.apply(jv, jb)
    got = model(tb)
    assert set(got) == set(want) == {"refined_masks", "alpha_os8"}
    for k in want:
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), np.asarray(want[k]))
    jout, jloss = jm.apply(jv, jb, train=True)
    model.train()
    out, loss = model(tb)
    assert list(loss) == list(jloss) == ["total"] and float(loss["total"]) == 0.0
    loss["total"].backward()
    assert float(model.scale.grad) == 0.0
    assert np.array_equal(out["refined_masks"].detach().numpy(), np.asarray(jout["refined_masks"]))


@pytest.fixture(scope="module")
def dummy_root(him_root):
    """``him_root`` with a train split ``tr`` (``tr/images``, ``tr/alphas``) of
    3 frames, one or two instances each."""
    root = os.path.join(him_root, "tr")
    rs = np.random.RandomState(1)
    for i in range(3):
        os.makedirs(os.path.join(root, "images"), exist_ok=True)
        Image.fromarray(rs.randint(0, 255, (72, 96, 3), np.uint8)).save(
            os.path.join(root, "images", f"t{i}.jpg"))
        os.makedirs(os.path.join(root, "alphas", f"t{i}"))
        for j in range(1 + i % 2):
            Image.fromarray(_blob(72, 96, 30 + 30 * j, 36, 20)).save(
                os.path.join(root, "alphas", f"t{i}", f"{j:02d}.png"))
    return him_root


def test_dummy_through_the_cli(dummy_root, tmp_path):
    """``main --eval-only --device cpu`` with ``model.arch Dummy``: the JAX
    package's ``test()`` metrics (its engine smoke test's arch); then two
    training iterations with a validation through the CLI: zero losses,
    ``scale`` left at 0, and ``best_model.npz`` carrying it across to both
    packages (``utils/convert_jax.py``)."""
    import jax
    from maggie_tpu.models import build_model as jax_build_model
    from maggie_tpu.utils.checkpoint import load_model_weights as jax_load_weights
    from maggie_tpu_torch.main import main
    from maggie_tpu_torch.utils.checkpoint import load_model_weights
    opts = _opts(dummy_root) + ["model.arch", "Dummy"]
    jcfg = jax_load_config(CONFIG, opts)
    want = jax_engine.test(jcfg)
    got = main(["--config", CONFIG, "--eval-only", "--device", "cpu", "name", "dummy_eval",
                "output_dir", str(tmp_path)] + opts)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert (tmp_path / "dummy_eval" / "results.csv").is_file()

    state = main(["--config", CONFIG, "--device", "cpu", "name", "dummy_train",
                  "output_dir", str(tmp_path)] + opts + [
                  "dataset.train.root_dir", dummy_root, "dataset.train.split", "tr",
                  "dataset.train.short_size", "64", "dataset.train.crop", "[64, 64]",
                  "train.batch_size", "2", "train.max_iter", "2", "train.val_iter", "2",
                  "train.log_iter", "1"])
    run = tmp_path / "dummy_train"
    assert state.step == 2 and float(state.model.scale.detach()) == 0.0
    log = (run / "log_rank0.log").read_text()
    assert "Validation:MAD" in log
    assert [float(v) for v in re.findall(r"total: ([-\w.]+)", log)] == [0.0, 0.0]
    npz = str(run / "best_model.npz")
    with np.load(npz) as data:
        assert sorted(data) == ["params/scale"] and float(data["params/scale"]) == 0.0
    cfg = load_config(None, ["model.arch", "Dummy", "model.weights", npz])
    model = load_model_weights(build_model(cfg.model, device="cpu"), cfg)
    assert float(model.scale.detach()) == 0.0
    jcfg.model.weights = npz
    jv = jax_load_weights(jax_build_model(jcfg.model), jcfg)
    assert float(jax.device_get(jv["params"]["scale"])) == 0.0
