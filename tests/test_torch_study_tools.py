"""The block-capacity studies on the port (``maggie_tpu_torch/tools/
cap_quality.py``, ``train_curve.py``, ``train_long.py``) against the JAX
package's tools (``tools/cap_quality.py``, ``tools/train_curve.py``,
``tools/train_long.py``), on the CPU.

- ``data/imgproc.py``'s ``fill_ellipse`` and ``gaussian_blur_f32`` against
  this host's cv2, bit for bit (the blur on OpenCV 5.0 with AVX2, asserted
  first: ``tests/cv2_warp.py``);
- the scenes: ``procedural_alpha`` and ``make_batch`` equal to the JAX
  tools';
- ``cap_quality``: each scene's dropped shares and active share equal to
  the JAX functions the tool composes, and the printed table equal to the
  JAX tool's, letter for letter;
- ``train_curve`` and ``train_long``: the model config and every step's
  learning rate equal to the JAX tools'; a short run of each on the CPU,
  finite, writing the JAX tools' JSON keys; ``train_long``'s checks on
  the state its run left equal to the JAX tool's check (the JAX eval
  forward on that state, converted). The step they drive is held against
  JAX elsewhere (``tests/test_torch_train.py``, ``tests/test_torch_remat.py``),
  so no JAX train step is traced here.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from cv2_warp import require_cv2_float_blur
from test_torch_harness import one_torch_thread  # noqa: F401
from maggie_tpu_torch.data import imgproc
from maggie_tpu_torch.engine.optim import build_lr_schedule
from maggie_tpu_torch.tools import cap_quality, train_curve, train_long

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


def jax_tool(name: str):
    """``tools/<name>.py`` as the module ``name`` (the JAX tools import each
    other by their bare names)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(TOOLS, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


# ------------------------------------------------------------- cv2 replicas
# axes (a, b) whose larger one takes each of cv2's arc steps: under 3 px (90
# degrees), under 10 (30), under 15 (18), and more (5)
ELLIPSE_AXES = {90: [(0, 0), (2, 1), (1, 2), (2, 2), (0, 2)],
                30: [(3, 3), (9, 4), (5, 9), (7, 0)],
                18: [(10, 12), (14, 6), (3, 14)],
                5: [(15, 15), (40, 23), (9, 60), (120, 144)]}


@pytest.mark.parametrize("delta", sorted(ELLIPSE_AXES))
def test_fill_ellipse_equals_cv2(delta):
    """``cv2.ellipse(img, center, axes, 0, 0, 360, value, -1)`` on float32
    images: centers inside, near and past every edge (the ellipse clipped),
    on zeros and on noise, values 1.0 and fractions; equal bit for bit."""
    rs = np.random.RandomState(delta)
    h, w = 47, 61
    drawn = 0
    for axes in ELLIPSE_AXES[delta]:
        reach = max(axes) + 2
        for cx in (-reach, -1, 0, 3, w // 2, w - 2, w - 1, w + reach // 2, w + reach):
            for cy in (-reach, 0, 1, h // 3, h - 1, h, h + reach // 2):
                value = 1.0 if (cx + cy) % 2 else float(rs.rand())
                img = (rs.rand(h, w).astype(np.float32) if cy % 3 == 0
                       else np.zeros((h, w), np.float32))
                want = img.copy()
                cv2.ellipse(want, (cx, cy), axes, 0, 0, 360, value, -1)
                got = imgproc.fill_ellipse(img.copy(), (cx, cy), axes, value)
                assert np.array_equal(got, want), (axes, (cx, cy), value,
                                                   np.argwhere(got != want)[:5].tolist())
                drawn += int((want != img).any())
    assert drawn > 0


@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_gaussian_blur_f32_equals_cv2(k):
    """``cv2.GaussianBlur(img, (k, k), 0)`` of float32 images: noise at sizes
    that leave every tail of cv2's vector loops (widths 1-37 and the
    studies' 192 and 1024), scaled noise, and filled ellipses (the studies'
    input); equal bit for bit."""
    require_cv2_float_blur()
    rs = np.random.RandomState(k)
    shapes = [(1, 17), (19, 1), (2, 3), (5, 7)] + [(int(rs.randint(2, 40)), w) for w in range(1, 38)]
    shapes += [(64, 192), (24, 1024)]
    images = [rs.rand(*s).astype(np.float32) * np.float32(10.0 ** rs.randint(-3, 3))
              for s in shapes]
    for seed in range(3):
        m = np.zeros((96, 160), np.float32)
        for _ in range(3):
            imgproc.fill_ellipse(m, (int(rs.randint(0, 160)), int(rs.randint(0, 96))),
                                 (int(rs.randint(3, 50)), int(rs.randint(3, 50))), 1.0)
        images.append(m)
    for img in images:
        want = cv2.GaussianBlur(img, (k, k), 0)
        got = imgproc.gaussian_blur_f32(img, k)
        assert got.dtype == np.float32 and np.array_equal(got, want), (
            img.shape, np.argwhere(got != want)[:5].tolist())


# ------------------------------------------------------------------ scenes
@pytest.mark.parametrize("size", [(128, 256), (192, 192)])
def test_procedural_alpha_and_make_batch_equal_jax_tools(size):
    """The port's scenes equal the JAX tools' for several seeds (the
    instance counts drawn and given)."""
    jcq, jtc = jax_tool("cap_quality"), jax_tool("train_curve")
    h, w = size
    for seed in (0, 1, 2, 7, 1000):
        want, got = jcq.procedural_alpha(seed, h, w), cap_quality.procedural_alpha(seed, h, w)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want), seed
        assert np.array_equal(cap_quality.procedural_alpha(seed, h, w, n_i=3),
                              jcq.procedural_alpha(seed, h, w, n_i=3))
    for seed in (0, 5, 1003):
        want, got = jtc.make_batch(seed, h, w), train_curve.make_batch(seed, h, w)
        assert set(got) == set(want)
        for key, v in want.items():
            assert got[key].dtype == v.dtype and np.array_equal(got[key], v), (seed, key)


# ---------------------------------------------------------------- cap_quality
CQ_ARGV = ["3", "128", "256"]


def jax_scene_stats(alpha: np.ndarray, caps=cap_quality.CAPS):
    """The JAX tool's per-scene composition (``tools/cap_quality.py:96-112``)."""
    import jax
    import jax.numpy as jnp
    from maggie_tpu.models.sparse_layers import active_pyramid
    from maggie_tpu.ops.morphology import compute_unknown
    n, h, w = alpha.shape
    nb = (h // 64) * (w // 64)
    unk = compute_unknown(jnp.asarray(alpha)[None], k_size=30, is_train=False)[0]
    _, _, _, m8 = active_pyramid(unk.reshape(n, h, w, 1))
    scores = m8[..., 0].reshape(n, h // 64, 8, w // 64, 8).sum((2, 4)).reshape(-1)
    total = jnp.maximum(jnp.sum(scores), 1.0)
    out = []
    for cap_frac in caps:
        cap = max(int(round(cap_frac * n * nb)), 1)
        top, _ = jax.lax.top_k(scores, min(cap, scores.shape[0]))
        out.append(1.0 - jnp.sum(top) / total)
    return np.asarray(jnp.stack(out)), float(jnp.mean((scores > 0).astype(jnp.float32)))


def test_cap_quality_equals_the_jax_composition_and_prints_its_table(capsys, monkeypatch):
    """On 3 scenes at 128x256: each scene's dropped share at every capacity
    and its active-block share equal the JAX functions' (K2's twin on the
    CPU); the printed table equals ``tools/cap_quality.py``'s, letter for
    letter."""
    res = cap_quality.main(CQ_ARGV + ["--device", "cpu"])
    table = capsys.readouterr().out
    for s in range(3):
        drops, active = jax_scene_stats(cap_quality.procedural_alpha(s, 128, 256))
        assert res["drops"][s].dtype == np.float32
        assert np.array_equal(res["drops"][s], drops), (s, res["drops"][s], drops)
        assert res["actives"][s] == active
    assert res["drops"][:, 0].max() > 0     # the lowest capacity drops active sites
    monkeypatch.setattr(sys, "argv", ["cap_quality.py"] + CQ_ARGV)
    jax_tool("cap_quality").main()
    assert table == capsys.readouterr().out
    assert len(res["alpha_s"]) == 3


# --------------------------------------------------- train_curve, train_long
def jax_study_cfg(tool: str, sparse_mode: str, iters: int):
    """The JAX tool's config, as ``tools/train_curve.py::run`` and
    ``tools/train_long.py::main`` build it."""
    sys.path.insert(0, os.path.dirname(TOOLS))
    from __graft_entry__ import _image_model_cfg
    cfg = _image_model_cfg(atten_dim=32, final_channel=32)
    if tool == "train_long":
        cfg.model.precision = "bf16"
    cfg.model.decoder_args.update(dict(
        sparse_mode=sparse_mode, block_cap_frac=0.5,
        inst_spec_dropout=0.0, detail_mask_dropout=0.0))
    cfg.train.optimizer.name = "adamw"
    cfg.train.optimizer.lr = 1.5e-4
    cfg.train.scheduler.name = "cosine"
    if tool == "train_long":
        cfg.train.max_iter = iters
        cfg.train.scheduler.warmup_iters = max(iters // 20, 1)
    else:
        cfg.train.max_iter = max(iters, 100)
        cfg.train.scheduler.warmup_iters = max(iters // 10, 1)
    return cfg


def port_study_cfg(tool: str, sparse_mode: str, iters: int):
    if tool == "train_long":
        return train_curve.study_cfg("block", 0.5, iters, max(iters // 20, 1), precision="bf16")
    return train_curve.study_cfg(sparse_mode, 0.5, max(iters, 100), max(iters // 10, 1))


@pytest.mark.parametrize("tool,sparse_mode,iters", [("train_curve", "oracle", 300),
                                                    ("train_curve", "block", 300),
                                                    ("train_curve", "block", 40),
                                                    ("train_long", "block", 2000)])
def test_study_config_and_lr_equal_jax(tool, sparse_mode, iters):
    """The model subtree of the study's config equals the JAX tool's, and so
    do the optimizer and schedule keys; the learning rate of every update of
    a run of ``iters`` equals JAX ``build_optimizer``'s schedule: 1e-6
    relative, and ``lr * eps(float32)`` absolute (1.8e-11) where the
    annealed rate is small, as JAX rounds the cosine's ``1 + cos`` to f32
    (one f32 step of it is ``lr / 2 * eps``; read 9.8e-12 at most over
    these runs, on rates under 1e-7, against the port's float64)."""
    from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
    jcfg, tcfg = jax_study_cfg(tool, sparse_mode, iters), port_study_cfg(tool, sparse_mode, iters)
    assert tcfg.model.to_dict() == jcfg.model.to_dict()
    assert tcfg.train.optimizer.to_dict() == jcfg.train.optimizer.to_dict()
    assert tcfg.train.scheduler.to_dict() == jcfg.train.scheduler.to_dict()
    assert tcfg.train.max_iter == jcfg.train.max_iter
    _, jfn = jax_build_optimizer(jcfg)
    tfn = build_lr_schedule(tcfg)
    want = np.asarray(jfn(np.arange(iters)), np.float64)
    got = np.array([tfn(s) for s in range(iters)])
    lr = float(tcfg.train.optimizer.lr)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=lr * float(np.finfo(np.float32).eps))


def _finite(values) -> bool:
    return bool(np.all(np.isfinite(values)))


def test_train_curve_runs_on_the_cpu(tmp_path, capsys):
    """``train_curve 3 64 OUT --device cpu``: both curves finite, the JSON
    the JAX tool's (a curve per ladder), its closing line."""
    out = tmp_path / "curve.json"
    curves = train_curve.main(["3", "64", str(out), "--device", "cpu"])
    with open(out) as f:
        saved = json.load(f)
    assert set(saved) == {"oracle", "block"} and saved == curves
    assert all(len(v) == 3 and _finite(v) for v in saved.values())
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("final-1 mean loss: oracle")


def test_train_long_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``train_long.run(3, 64, 2)`` on the CPU: finite losses, checks at
    iterations 0 and 2 (every 2nd and the last) with the JAX tool's keys,
    each step and check timed; ``train_long 3 64 OUT 2 --device cpu``
    passes its arguments to ``run`` and writes the JAX tool's JSON and
    closing line."""
    out = tmp_path / "long.json"
    record = {}
    res = train_long.run(3, 64, 2, torch.device("cpu"), record=record)
    assert len(res["losses"]) == 3 and _finite(res["losses"])
    assert [v["iter"] for v in res["val"]] == [0, 2]
    for v in res["val"]:
        assert set(v) == {"iter", "MADx1e3", "MSEx1e3", "loss"} and _finite(list(v.values()))
    assert len(record["seconds"]) == 3 and len(record["val_seconds"]) == 2
    assert record["val_launches"] == [dict.fromkeys(
        ("gather_patches", "gather_patches_bwd", "compute_unknown"), 0)] * 2   # plain twins

    def ran(iters, size, val_every, device):
        assert (iters, size, val_every, device.type) == (3, 64, 2, "cpu")
        return res
    monkeypatch.setattr(train_long, "run", ran)
    saved = train_long.main(["3", "64", str(out), "2", "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == saved == res
    assert set(saved) == {"losses", "val", "iters", "size"} and saved["size"] == 64
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: mean loss first-50")


# train_long's checks against the JAX eval forward on the same trained state.
# f32: the alphas within test_torch_maggie.py's 1e-5 (read 1.2e-7), the MAD
# and MSE within 1e-5 relative. bf16, the study's own precision: the two
# packages round their bf16 convolutions at different points, which moves an
# alpha by a few bf16 steps and flips a detail-mask pixel where an alpha lies
# that close to a threshold; so a scene's mean |d| within one bf16 step at
# 1.0, 2^-8 (read 1.2e-4 to 1.6e-3 with one torch thread), at most 2% of its
# pixels beyond 1e-2 (read 0.05% to 0.83%), and the MAD and MSE within 1e-3
# relative (read 2.5e-4).
LONG_CHECK_TOL = {"fp32": {"atol": 1e-5, "mean": 1e-5, "far": 0.0, "rel": 1e-5},
                  "bf16": {"atol": None, "mean": 2.0 ** -8, "far": 0.02, "rel": 1e-3}}


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_train_long_checks_equal_jax_eval_forward(precision, monkeypatch):
    """``train_long.run(3, 64, 2)`` on the CPU (f32: the same run with
    ``model.precision fp32``), then its last check against the JAX tool's
    check on the state the run left: ``model.apply(train=False)`` with the
    port's parameters, BatchNorm statistics and spectral u/v carried over by
    ``to_jax``, on the 8 held-out scenes. Every scene's alphas and the
    check's MAD and MSE agree within ``LONG_CHECK_TOL``: the eval forward of
    a model trained under selective remat is the JAX package's."""
    import jax
    from maggie_tpu.models import build_model as jax_build_model
    from maggie_tpu_torch.utils.convert_jax import to_jax
    from test_torch_harness import jax_variables
    tol, kept = LONG_CHECK_TOL[precision], {}
    trainer, study_cfg = train_long.trainer, train_long.study_cfg

    def keeping(cfg, device, remat):
        kept["state"], step = trainer(cfg, device, remat=remat)
        return kept["state"], step
    monkeypatch.setattr(train_long, "trainer", keeping)
    monkeypatch.setattr(train_long, "study_cfg",
                        lambda *a, **kw: study_cfg(*a, **dict(kw, precision=precision)))
    res = train_long.run(3, 64, 2, torch.device("cpu"))
    state = kept["state"]
    jcfg = jax_study_cfg("train_long", "block", 3)
    jcfg.model.precision = precision
    jm = jax_build_model(jcfg.model)
    fwd = jax.jit(lambda v, b: jm.apply(v, b, train=False)["refined_masks"])
    jv = jax_variables(to_jax({**state.params(), **state.batch_stats(), **state.spectral()}))
    mads, mses = [], []
    state.model.eval()
    for j in range(train_long.VAL_SCENES):
        batch = train_curve.make_batch(1000 + j, 64, 64)
        want = np.asarray(fwd(jv, batch), np.float32)
        with torch.no_grad():
            got = state.model(train_curve.on_device(batch, torch.device("cpu")))
        d = np.abs(got["refined_masks"].float().numpy() - want)
        if tol["atol"] is not None:
            assert d.max() <= tol["atol"], (j, float(d.max()))
        assert d.mean() <= tol["mean"] and (d > 1e-2).mean() <= tol["far"], (
            j, float(d.mean()), float((d > 1e-2).mean()))
        gt = batch["alpha"].astype(np.float32)
        mads.append(float(np.abs(want - gt).mean() * 1e3))
        mses.append(float(((want - gt) ** 2).mean() * 1e3))
    last = res["val"][-1]
    assert last["iter"] == 2
    got, want = [last["MADx1e3"], last["MSEx1e3"]], [np.mean(mads), np.mean(mses)]
    print(f"{precision}: MAD, MSE x1e3 {got} vs JAX {want}")
    np.testing.assert_allclose(got, want, rtol=tol["rel"], atol=0)
