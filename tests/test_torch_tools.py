"""The port's tools (``maggie_tpu_torch/tools/``) against the JAX package's
(``tools/gen_mask/gen_mask.py``, ``tools/train_supervisor.py``), on the CPU.

- ``gen_mask``: both tools on one synthetic HIM root (96x128 masks, one
  instance under 2% of the area), each variant: the same file names, the
  masks decoded equal; both refusals raise.
- ``train_supervisor``: the JAX supervisor's four behaviours (restart with
  resume, crash loop, ``--max-restarts``, a backend outage) through the
  port's, with a stand-in trainer as ``tests/test_supervisor.py`` has it (its
  checkpoint is the file ``last_state.pt``), and the trainer flags forwarded.
- A real supervised run: the port's trainer at small width with ``--device
  cpu``, ``MAGGIE_FAULT_INJECT_ITER`` 3 and ``max_iter`` 4, whose
  ``last_state.pt`` equals the manual pair "a run that fails at 3, then
  ``train.resume_last True``" bit for bit. Every child runs one torch thread,
  so the two sides sum in one order.
"""

import glob
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from maggie_tpu_torch.demo.segmenters import MaskRCNNOnnxSegmenter
from maggie_tpu_torch.tools import gen_mask as port_gen_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "maggie_image.yaml")
SUPERVISOR = [sys.executable, "-m", "maggie_tpu_torch.tools.train_supervisor"]
CHILD_ENV = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _jax_gen_mask():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_mask", os.path.join(REPO, "tools", "gen_mask", "gen_mask.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def him_masks_root(tmp_path_factory):
    """``images/natural/*.jpg`` and ``alphas/natural/<image>/*.png``: 3 images
    of 96x128 with 2-3 blob instances, the last image's last one under 2%."""
    root = tmp_path_factory.mktemp("gen_mask")
    rs = np.random.RandomState(0)
    h, w = 96, 128
    for i in range(3):
        (root / "images" / "natural").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "images" / "natural" / f"img{i}.jpg")
        adir = root / "alphas" / "natural" / f"img{i}"
        adir.mkdir(parents=True)
        for j in range(2 + i % 2):
            a = _blob(h, w, rs.randint(30, w - 30), rs.randint(30, h - 30), rs.randint(16, 30))
            Image.fromarray(a).save(adir / f"{j:02d}.png")
    tiny = np.zeros((h, w), np.uint8)
    tiny[:3, :3] = 255
    Image.fromarray(tiny).save(root / "alphas" / "natural" / "img2" / "09.png")
    return str(root)


def _written(root, name):
    base = os.path.join(root, f"masks_{name}")
    return sorted(os.path.relpath(p, base) for p in glob.glob(os.path.join(base, "*", "*", "*.png")))


@pytest.mark.parametrize("variant", sorted(port_gen_mask.VARIANTS))
def test_gen_mask_writes_the_jax_tools_masks(him_masks_root, variant):
    jax_tool = _jax_gen_mask()
    states = {}
    for side, run in (("jax", jax_tool.gen_alpha_backend),
                      ("port", port_gen_mask.gen_alpha_backend)):
        np.random.seed(0)   # the boundary walk draws from the global generator
        n = run(him_masks_root, ["natural"], f"{side}_{variant}", variant, "alphas", 3)
        states[side] = (n, np.random.get_state()[1].copy(), np.random.get_state()[2])
    # 8 instances: the tiny one is always dropped, and a walk may shrink another below 2%
    assert states["port"][0] == states["jax"][0] and 0 < states["jax"][0] < 8
    assert np.array_equal(states["port"][1], states["jax"][1])
    assert states["port"][2] == states["jax"][2]
    files = _written(him_masks_root, f"jax_{variant}")
    assert files == _written(him_masks_root, f"port_{variant}") and len(files) == states["jax"][0]
    for rel in files:
        want = np.array(Image.open(os.path.join(him_masks_root, f"masks_jax_{variant}", rel)))
        got = np.array(Image.open(os.path.join(him_masks_root, f"masks_port_{variant}", rel)))
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), rel
        assert set(np.unique(got)) <= {0, 255}


def test_gen_mask_cli_drops_small_masks(him_masks_root, capsys):
    n = port_gen_mask.main(["--root", him_masks_root, "--subsets", "natural", "--name", "cli",
                            "--variant", "clean", "--seed", "0"])
    assert n == 7 and "wrote 7 masks" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(him_masks_root, "masks_cli", "natural", "img2"))) == \
        ["00.png", "01.png"]    # img2's third instance is under 2% of the area


@pytest.mark.parametrize("backend", ["onnx", "detectron2"])
def test_gen_mask_refusals_raise(him_masks_root, backend, monkeypatch):
    jax_tool = _jax_gen_mask()
    argv = ["--root", him_masks_root, "--subsets", "natural", "--name", "x", "--backend", backend]
    if backend == "onnx":
        with pytest.raises(RuntimeError, match="onnxruntime") as jax_err:
            jax_tool.gen_onnx_backend(him_masks_root, ["natural"], "x")
        with pytest.raises(RuntimeError) as port_err:
            port_gen_mask.main(argv)
        assert str(port_err.value) == MaskRCNNOnnxSegmenter.RECIPE
        assert "MaskRCNN-10.onnx" in str(jax_err.value)
    else:
        monkeypatch.setattr(sys, "argv", ["gen_mask.py"] + argv)
        with pytest.raises(SystemExit) as jax_exit:
            jax_tool.main()
        with pytest.raises(SystemExit) as port_exit:
            port_gen_mask.main(argv)
        assert str(port_exit.value) == str(jax_exit.value) == port_gen_mask.DETECTRON2_MESSAGE


def _fake_main(tmp_path, body: str) -> str:
    """A stand-in for ``python -m maggie_tpu_torch.main`` with the same CLI shape."""
    p = tmp_path / "fake_main.py"
    p.write_text(textwrap.dedent("""\
        import argparse, os, sys
        parser = argparse.ArgumentParser()
        parser.add_argument("--config", required=True)
        parser.add_argument("--device")
        parser.add_argument("--precision")
        parser.add_argument("opts", nargs=argparse.REMAINDER)
        args = parser.parse_args()
        opts = dict(zip(args.opts[::2], args.opts[1::2]))
        out = os.path.join(opts["output_dir"], opts.get("name", "default"))
        os.makedirs(out, exist_ok=True)
        resumed = opts.get("train.resume_last", "") == "True"
        step_file = os.path.join(out, "last_step.txt")
        ckpt = os.path.join(out, "last_state.pt")
    """) + textwrap.dedent(body))
    (tmp_path / "min.yaml").write_text("name: default\n")
    return str(p)


RESUMES = """\
    if not resumed:
        open(ckpt, "w").write("state")
        open(step_file, "w").write("5")
        sys.exit(1)  # a preemption after saving iteration 5
    assert open(step_file).read() == "5"
    open(os.path.join(out, "done.txt"), "w").write("ok")
"""
CRASHES = """\
    sys.exit(7)  # crashes before ever checkpointing
"""
PROGRESSES = """\
    open(ckpt, "w").write("state")
    prev = int(open(step_file).read()) if os.path.exists(step_file) else 0
    open(step_file, "w").write(str(prev + 1))  # always makes progress
    sys.exit(3)
"""
RUNS = """\
    open(os.path.join(out, "ran.txt"), "w").write(" ".join(sys.argv[1:]))
"""

# (trainer body, supervisor flags, probe failures first, rc, printed, not printed, file)
BEHAVIOURS = {
    "restarts_and_resumes": (RESUMES, (), 0, 0, ("launch #1", "train.resume_last True"),
                             ("launch #2",), "done.txt"),
    "gives_up_on_crash_loop": (CRASHES, (), 0, 7, ("crash loop", "launch #2"),
                               ("launch #3",), None),
    "respects_max_restarts": (PROGRESSES, ("--max-restarts", "2"), 0, 3,
                              ("exceeded --max-restarts=2", "launch #2"), ("launch #3",), None),
    "waits_out_backend_outage": (RUNS, (), 2, 0, ("backend unreachable", "launch #0"),
                                 ("launch #1",), "ran.txt"),
}


@pytest.mark.parametrize("case", sorted(BEHAVIOURS))
def test_supervisor_behaviours(tmp_path, case):
    """The JAX supervisor's behaviours (``tests/test_supervisor.py``) through
    the port's: a probe that fails ``down`` times before it passes stands
    for an outage, which counts as no failure."""
    body, flags, down, rc, printed, absent, made = BEHAVIOURS[case]
    fake = _fake_main(tmp_path, body)
    flag = tmp_path / "probes"
    probe = (f'echo x >> "{flag}"; [ "$(wc -l < "{flag}")" -gt {down} ]')
    out = str(tmp_path / "run")
    env = dict(os.environ, MAGGIE_SUPERVISOR_MAIN=fake, MAGGIE_SUPERVISOR_PROBE=probe,
               MAGGIE_SUPERVISOR_PROBE_INTERVAL="0.01")
    r = subprocess.run(SUPERVISOR + ["--config", str(tmp_path / "min.yaml"), "--backoff", "0.01",
                                     *flags, "--", "output_dir", out],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == rc, r.stdout + r.stderr
    for s in printed:
        assert s in r.stdout, r.stdout
    for s in absent:
        assert s not in r.stdout, r.stdout
    if made:
        assert os.path.exists(os.path.join(out, "default", made))


def test_supervisor_forwards_trainer_flags(tmp_path):
    """``--device`` and ``--precision`` after ``--`` reach the trainer as its
    flags, the rest as overrides; with ``--device cpu`` nothing is probed."""
    fake = _fake_main(tmp_path, RUNS)
    out = str(tmp_path / "run")
    env = {k: v for k, v in os.environ.items() if k != "MAGGIE_SUPERVISOR_PROBE"}
    env["MAGGIE_SUPERVISOR_MAIN"] = fake
    r = subprocess.run(SUPERVISOR + ["--config", str(tmp_path / "min.yaml"), "--",
                                     "output_dir", out, "--device", "cpu", "--precision", "16",
                                     "name", "run"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    argv = open(os.path.join(out, "run", "ran.txt")).read().split()
    assert argv == ["--config", str(tmp_path / "min.yaml"), "--device", "cpu",
                    "--precision", "16", "output_dir", out, "name", "run"]
    assert "backend probe ok" in r.stdout and "launch #1" not in r.stdout


def _train_root(root):
    """A train split ``tr`` of 4 frames (1-2 blob instances) and an eval split
    ``val`` of 1, at 80x120."""
    rs = np.random.RandomState(0)
    h, w = 80, 120
    for i in range(4):
        (root / "tr" / "images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            root / "tr" / "images" / f"t{i}.jpg")
        (root / "tr" / "alphas" / f"t{i}").mkdir(parents=True)
        for j in range(1 + i % 2):
            Image.fromarray(_blob(h, w, rs.randint(20, w - 20), rs.randint(20, h - 20),
                                  rs.randint(14, 30))).save(
                root / "tr" / "alphas" / f"t{i}" / f"{j:02d}.png")
    (root / "images" / "val").mkdir(parents=True)
    Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
        root / "images" / "val" / "v0.jpg")
    for d in ("alphas", "masks"):
        (root / d / "val" / "v0").mkdir(parents=True)
        Image.fromarray(_blob(h, w, w // 2, h // 2, h // 3)).save(root / d / "val" / "v0" / "00.png")


def test_supervised_cpu_run_equals_the_manual_fault_then_resume(tmp_path):
    root = tmp_path / "him"
    _train_root(root)
    opts = ["output_dir", str(tmp_path / "out"),
            "dataset.train.root_dir", str(root), "dataset.train.split", "tr",
            "dataset.train.short_size", "64", "dataset.train.crop", "[64, 64]",
            "dataset.test.root_dir", str(root), "dataset.test.split", "val",
            "dataset.test.short_size", "64", "dataset.test.mask_dir_name", "masks",
            "model.decoder_args.atten_dim", "32", "model.decoder_args.final_channel", "32",
            "train.batch_size", "2", "train.max_iter", "4", "train.ckpt_iter", "1",
            "train.val_iter", "100", "train.log_iter", "1"]
    env = dict(os.environ, MAGGIE_FAULT_INJECT_ITER="3", **CHILD_ENV)
    env.pop("MAGGIE_SUPERVISOR_MAIN", None)
    env.pop("MAGGIE_SUPERVISOR_PROBE", None)
    r = subprocess.run(SUPERVISOR + ["--config", CONFIG, "--backoff", "0.01", "--",
                                     "--device", "cpu", "name", "supervised", *opts],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    launches = [line for line in r.stdout.splitlines() if "] launch #" in line]
    assert len(launches) == 2 and "train.resume_last" not in launches[0]
    assert launches[1].endswith("train.resume_last True") and "--device cpu" in launches[1]
    assert "fault injection at iter 3" in r.stderr

    trainer = [sys.executable, "-m", "maggie_tpu_torch.main", "--config", CONFIG,
               "--device", "cpu", "name", "manual", *opts]
    fresh = subprocess.run(trainer, capture_output=True, text=True, env=env, cwd=REPO,
                           timeout=600)
    assert fresh.returncode != 0 and "fault injection at iter 3" in fresh.stderr
    resumed = subprocess.run(trainer + ["train.resume_last", "True"], capture_output=True,
                             text=True, env=env, cwd=REPO, timeout=600)
    assert resumed.returncode == 0, resumed.stderr[-4000:]

    runs = {}
    for name in ("supervised", "manual"):
        out = tmp_path / "out" / name
        assert open(out / "last_step.txt").read().strip() == "4"
        runs[name] = torch.load(out / "last_state.pt", map_location="cpu", weights_only=True)
    sup, man = runs["supervised"], runs["manual"]
    assert sup["step"] == man["step"] == 4
    assert sup["model"].keys() == man["model"].keys()
    for k, v in sup["model"].items():
        assert torch.equal(v, man["model"][k]), k
    so, mo = sup["optimizer"]["state"], man["optimizer"]["state"]
    assert so.keys() == mo.keys() and len(so) > 0
    for i in so:
        for k in so[i]:
            assert torch.equal(so[i][k], mo[i][k]), (i, k)
