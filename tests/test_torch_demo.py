"""The port's demo (``maggie_tpu_torch/demo/``) against the JAX package's
(``demo/``) on the CPU.

- Image: ``app.inference_image`` and ``predict.py image`` on both sides, the
  reduced flagship (``tests/test_torch_harness.py``'s widths) on the same
  JAX ``.npz`` weights: the JAX model goes into ``app._STATE`` (and replaces
  ``predict.build``) as ``tests/test_demo_app.py`` does, the port loads the
  ``.npz`` through its own ``build``. The float mattes (``reverse_transform``'s
  output, before the clamp) agree within 1e-5; the written PNGs and the
  composites are equal except where a float lies within 1e-5 of an 8-bit
  rounding edge (the clamp's 1/255 and 254/255 are such edges).
- Video: ``app.inference_video`` with masks for every frame (4 frames, two
  windows, the second with the first's alpha carried), by the same rules.
- The demo resizes every frame to ``FRAME_TF``'s short side (576); here
  both sides' ``ResizeShort`` take DEMO_SHORT (128) instead, so the 64x64
  inputs are upsampled and the mattes resized back as on the real path,
  and the models run at 128x128. The K2 band, the video model's snap, box,
  rule and candidate thresholds keep a margin from every value they read
  (asserted), so that float rounding cannot flip a pixel. A band that
  covers part of a map nearly always has an alpha within 1e-5 of its edge
  (at 128x128, weight seeds 1-3, 6-15, 17-22 and 25-29 of the image model
  read 0 to 1.3e-5): the weight seeds put every os8 alpha inside K2's
  band, 0.06 from its edges for the image (seed 5), 0.0039 for the video
  (seed 2), whose rule's change maps keep 1.1e-4 from 0.5.
- Segmenters: ``MaskFileSegmenter`` and ``_overlay`` equal to JAX's; the
  port's ``FlowPropagator`` (no cv2) against JAX's (cv2) on a moving-blob
  clip, label maps equal on at least 99.5% of the pixels (the flow's own
  precedent, ``tests/test_torch_flow.py``); its flow, grey conversion, remap
  and close against cv2.
- The server: ``launch_http`` on port 0 in a thread: ``GET``, ``POST
  /image``, an unknown path (404) and a request that raises (500).
- Devices and refusals: the entry points raise without a GPU unless asked
  for the CPU; the external backends raise with their recipes.
"""

import contextlib
import io
import os
import sys
import threading
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest
import jax
import torch
from PIL import Image

import maggie_tpu_torch.demo.app as papp
import maggie_tpu_torch.demo.predict as ppredict
import maggie_tpu_torch.demo.segmenters as pseg
import maggie_tpu_torch.models.decoder_sparse as tds
import maggie_tpu_torch.models.decoder_video as tdv
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.ops.morphology import LOWER_THRES, UPPER_THRES
from maggie_tpu_torch.utils.convert_jax import to_jax
from test_torch_harness import (jax_cfg, jax_shapes, jax_variables, one_torch_thread,  # noqa: F401
                                random_flat)
from test_torch_video import assert_margins, threshold_margins, video_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "demo"))
import app as japp  # noqa: E402
import predict as jpredict  # noqa: E402
import segmenters as jseg  # noqa: E402

cv2 = pytest.importorskip("cv2", reason="cv2 (the JAX demo's flow) is not installed")

ATOL = 1e-5
K2_MARGIN = 1e-5     # least distance of a K2 input from its band's edges
DEMO_SHORT = 128     # both demos' ResizeShort here (576 in FRAME_TF)


@pytest.fixture(autouse=True, scope="module")
def demo_short_side():
    """Both sides' ``FRAME_TF`` resize to DEMO_SHORT on the short side."""
    resizes = [jpredict.FRAME_TF.transforms[0], ppredict.FRAME_TF.transforms[0]]
    assert all(r.short_size == 576 for r in resizes)
    for r in resizes:
        r.short_size = DEMO_SHORT
    yield
    for r in resizes:
        r.short_size = 576


class Args:
    config = video_config = None
    weights = video_weights = ""
    device = "cpu"


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return np.clip((r - d) / max(r * 0.3, 1), 0, 1)


def _image_and_masks(tmp, h=64, w=64):
    rs = np.random.RandomState(0)
    img = Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8))
    paths = []
    for i, (cx, cy, r) in enumerate(((20, 30, 14), (44, 34, 16))):
        p = os.path.join(tmp, f"m{i}.png")
        Image.fromarray(((_blob(h, w, cx, cy, r) > 0.5) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return img, paths


def _clip(root, n_f, h=64, w=64, masks_for=None):
    """A clip of ``n_f`` frames with two textured blobs that move, and one mask
    dir per frame in ``masks_for`` (every frame when None)."""
    rs = np.random.RandomState(5)
    bg = (rs.rand(h, w, 3) * 200).astype(np.uint8)
    patch = (rs.rand(20, 20, 3) * 255).astype(np.uint8)
    fdir, mdir = os.path.join(root, "frames"), os.path.join(root, "masks")
    os.makedirs(fdir)
    for t in range(n_f):
        img = bg.copy()
        boxes = ((10 + 2 * t, 6 + 3 * t), (34 - t, 36 - 2 * t))
        for y, x in boxes:
            img[y:y + 20, x:x + 20] = patch
        Image.fromarray(img).save(os.path.join(fdir, f"f{t}.png"))
        if masks_for is None or t in masks_for:
            os.makedirs(os.path.join(mdir, f"f{t}"))
            for i, (y, x) in enumerate(boxes):
                m = np.zeros((h, w), np.uint8)
                m[y:y + 20, x:x + 20] = 255
                Image.fromarray(m).save(os.path.join(mdir, f"f{t}", f"{i:02d}.png"))
    return fdir, mdir


def _near_edge(flt, tol=ATOL):
    """Where ``flt`` (an alpha) lies within ``tol`` of an 8-bit edge k/255
    (the clamp's 1/255 and 254/255 among them)."""
    v = np.asarray(flt, np.float64) * 255.0
    return np.abs(v - np.rint(v)) < tol * 255.0


def _equal_off_edges(got_u8, want_u8, near):
    """The 8-bit arrays are equal except where ``near`` (broadcast over a
    trailing channel axis) allows; returns the count of differing values."""
    diff = got_u8 != want_u8
    if diff.ndim > near.ndim:
        near = np.broadcast_to(near[..., None], diff.shape)
    assert not (diff & ~near).any(), f"{int((diff & ~near).sum())} values differ off an edge"
    return int(diff.sum())


def _composite_edges(img, alpha):
    """Where a composite ``img * a + (1 - a) * green`` may round otherwise
    for an alpha within ATOL: its float within 255 ATOL of an integer, or
    the clamped alpha near an edge (0 and 1 included: a clamp that flips)."""
    green = np.zeros_like(img, np.float64)
    green[..., 1] = 255
    a = alpha.astype(np.float64)[..., None]
    comp = img * a + (1 - a) * green
    return (np.abs(comp - np.rint(comp)) < 255.0 * ATOL).any(-1) | _near_edge(alpha)


@contextlib.contextmanager
def _spies(jax_mods, papp_mod):
    """Record both sides' ``reverse_transform`` outputs (the float mattes
    before the clamp), the composites with their inputs, and the port's K2
    inputs' least distance from the band's edges."""
    rec = {"jax": [], "port": [], "jcomp": [], "pcomp": [], "k2": []}
    patched = []

    def patch(mod, name, spy):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, spy(getattr(mod, name)))

    def spy_rev(key):
        def wrap(fn):
            def spy(x, info):
                out = fn(x, info)
                rec[key].append(np.array(out))
                return out
            return spy
        return wrap

    def spy_comp(key):
        def wrap(fn):
            def spy(image, alpha):
                out = fn(image, alpha)
                rec[key].append((np.array(image.convert("RGB")), np.array(alpha),
                                 [np.array(o) for o in out]))
                return out
            return spy
        return wrap

    def spy_unknown(fn):
        def spy(x, k_size):
            rec["k2"].append(float(torch.minimum((x - LOWER_THRES).abs(),
                                                 (x - UPPER_THRES).abs()).min()))
            return fn(x, k_size)
        return spy

    for mod in jax_mods:
        patch(mod, "reverse_transform", spy_rev("jax"))
        if hasattr(mod, "_matte_composites"):
            patch(mod, "_matte_composites", spy_comp("jcomp"))
    patch(ppredict, "reverse_transform", spy_rev("port"))
    patch(papp_mod, "_matte_composites", spy_comp("pcomp"))
    for m in (tds, tdv):
        patch(m, "compute_unknown", spy_unknown)
    try:
        yield rec
    finally:
        for mod, name, fn in reversed(patched):
            setattr(mod, name, fn)


def _check_mattes(rec, n):
    """The float mattes within ATOL, K2's inputs off its band's edges, the
    composites equal off the edges; returns the count of differing values."""
    assert len(rec["jax"]) == len(rec["port"]) == n
    for j, p in zip(rec["jax"], rec["port"]):
        assert j.shape == p.shape
        np.testing.assert_allclose(p, j, rtol=0, atol=ATOL)
    assert min(rec["k2"]) > K2_MARGIN, min(rec["k2"])
    assert len(rec["jcomp"]) == len(rec["pcomp"]) > 0
    flips = 0
    for (img, ja, jc), (_, pa, pc) in zip(rec["jcomp"], rec["pcomp"]):
        for i, (a, b) in enumerate(zip(jc, pc)):
            flips += _equal_off_edges(b, a, _composite_edges(img, ja[i]))
    return flips


def _jit_model(jm):
    """The JAX model with ``apply`` jitted (the demo calls ``apply`` eagerly,
    op by op, which the suite cannot afford)."""
    fwd = jax.jit(lambda v, b, pp: jm.apply(v, b, train=False, prev_pred=pp))

    class Jitted:
        def apply(self, variables, batch, train=False, prev_pred=None):
            assert not train
            return fwd(variables, batch, prev_pred)
    return Jitted()


def _write_npz(path, flat):
    np.savez(path, **flat)
    return path


def _npz_variables(path):
    """The JAX variables of an ``.npz`` of flat keys (``save_variables_npz``'s
    layout), as the JAX package's loader reads them into its tree."""
    with np.load(path) as data:
        return jax_variables(dict(data.items()))



@pytest.fixture(scope="module")
def image_pair(tmp_path_factory):
    """(JAX model, its variables read from the .npz, port model, npz path):
    the reduced flagship at weight seed 5 (see the module docstring)."""
    jcfg = jax_cfg()
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed=5)
    path = _write_npz(str(tmp_path_factory.mktemp("w") / "image.npz"), flat)
    pcfg = ConfigNode({"model": jcfg.model.to_dict()})
    model = ppredict.build(pcfg, path, video=False, device="cpu")
    return _jit_model(jm), _npz_variables(path), model, path


@pytest.fixture(scope="module")
def video_pair(tmp_path_factory):
    """The same for ``tests/test_torch_video.py``'s reduced video model at
    weight seed 2 (see the module docstring)."""
    cfg = video_cfg()
    pcfg = ConfigNode({"model": cfg.model.to_dict()})
    shapes = {k: v.shape for k, v in to_jax(build_model(pcfg.model, device="cpu")
                                            .state_dict()).items()}
    flat = random_flat(dict(sorted(shapes.items())), seed=2)
    path = _write_npz(str(tmp_path_factory.mktemp("w") / "video.npz"), flat)
    model = ppredict.build(pcfg, path, video=True, device="cpu")
    return _jit_model(jax_build_model(cfg.model)), _npz_variables(path), model, path


def test_inference_image_matches_jax(image_pair, tmp_path, monkeypatch):
    jm, jv, model, _ = image_pair
    img, paths = _image_and_masks(str(tmp_path))
    monkeypatch.setitem(japp._STATE, "image_model", (jm, jv))
    monkeypatch.setitem(papp._STATE, "image_model", model)
    with _spies([japp], papp) as rec:
        jvis, jmattes = japp.inference_image(Args(), img, paths)
        pvis, pmattes = papp.inference_image(Args(), img, paths)
    assert len(pmattes) == len(jmattes) == 2 and pmattes[0].size == img.size
    assert np.array_equal(np.array(pvis), np.array(jvis))
    _check_mattes(rec, 1)
    with pytest.raises(RuntimeError, match="No person"):
        empty = tmp_path / "empty.png"
        Image.fromarray(np.zeros((64, 64), np.uint8)).save(empty)
        papp.inference_image(Args(), img, [str(empty)])


def test_predict_image_writes_the_jax_pngs(image_pair, tmp_path, monkeypatch):
    """``python -m maggie_tpu_torch.demo.predict image --device cpu`` and
    ``demo/predict.py image`` on the same weights: the same PNGs."""
    jm, jv, model, path = image_pair
    img, paths = _image_and_masks(str(tmp_path))
    img_path = str(tmp_path / "img.png")
    img.save(img_path)
    monkeypatch.setattr(jpredict, "build", lambda *a, **k: (jm, jv))
    monkeypatch.setattr(ppredict, "build", lambda cfg, w, video, device=None: model)
    cli = ["image", "--weights", path, "--image", img_path, "--masks"] + paths
    monkeypatch.setattr(sys, "argv", ["predict.py"] + cli + ["--out", str(tmp_path / "jax")])
    with _spies([jpredict], papp) as rec:
        jpredict.main()
        ppredict.main(cli + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(rec["jax"]) == len(rec["port"]) == 1
    np.testing.assert_allclose(rec["port"][0], rec["jax"][0], rtol=0, atol=ATOL)
    assert min(rec["k2"]) > K2_MARGIN
    for i in range(2):
        rel = os.path.join("img", f"{i:02d}.png")
        got = np.array(Image.open(tmp_path / "port" / rel))
        want = np.array(Image.open(tmp_path / "jax" / rel))
        _equal_off_edges(got, want, _near_edge(rec["jax"][0][0, 0, i]))


def test_inference_video_matches_jax(video_pair, tmp_path, monkeypatch):
    """Masks for every frame: 4 frames, 2 windows; the float mattes of each
    window and the written composites."""
    jm, jv, model, _ = video_pair
    fdir, mdir = _clip(str(tmp_path), 4)
    monkeypatch.setitem(japp._STATE, "video_model", (jm, jv))
    monkeypatch.setitem(papp._STATE, "video_model", model)
    with _spies([japp], papp) as rec, threshold_margins() as margins:
        jw, jvid = japp.inference_video(Args(), fdir, mdir, "flow", str(tmp_path / "jax"))
        pw, pvid = papp.inference_video(Args(), fdir, mdir, "flow", str(tmp_path / "port"))
    assert_margins(margins, 2)
    assert [os.path.basename(p) for p in pw] == [os.path.basename(p) for p in jw]
    assert len(pw) == 4 and all(os.path.exists(p) for p in pw)
    assert pvid is not None and os.path.getsize(pvid) > 0
    flips = _check_mattes(rec, 2)
    if not flips:   # equal composites make equal JPEGs
        for p, j in zip(pw, jw):
            assert np.array_equal(np.array(Image.open(p)), np.array(Image.open(j))), p


def test_predict_video_writes_the_jax_pngs(video_pair, tmp_path, monkeypatch):
    """``predict video`` on both sides with masks for every frame (4 frames,
    2 windows): the float mattes of each window within ATOL and the same
    PNGs off the 8-bit edges. On a 2-frame clip, which the port pads to its
    window, one PNG per frame and instance; ``demo/predict.py`` has no
    padding and raises IndexError there (``:134``, a fault of the JAX
    package's demo, ROADMAP queue 3)."""
    jm, jv, model, path = video_pair
    fdir, mdir = _clip(str(tmp_path / "a"), 4)
    monkeypatch.setattr(jpredict, "build", lambda *a, **k: (jm, jv))
    monkeypatch.setattr(ppredict, "build", lambda cfg, w, video, device=None: model)
    cli = ["video", "--weights", path, "--frames", fdir, "--masks", mdir]
    monkeypatch.setattr(sys, "argv", ["predict.py"] + cli + ["--out", str(tmp_path / "jax")])
    with _spies([jpredict], papp) as rec, threshold_margins() as margins:
        jpredict.main()
        ppredict.main(cli + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    assert_margins(margins, 2)
    assert len(rec["jax"]) == len(rec["port"]) == 2
    for j, p in zip(rec["jax"], rec["port"]):
        np.testing.assert_allclose(p, j, rtol=0, atol=ATOL)
    assert min(rec["k2"]) > K2_MARGIN
    for t in range(4):     # frame 0 from window 0, frames 1-3 from window 1 (the last)
        flt = rec["jax"][0][0, 0] if t == 0 else rec["jax"][1][0, t - 1]
        for i in range(2):
            rel = os.path.join(f"f{t}", f"{i:02d}.png")
            got = np.array(Image.open(tmp_path / "port" / rel))
            want = np.array(Image.open(tmp_path / "jax" / rel))
            _equal_off_edges(got, want, _near_edge(flt[i]))
    fdir, mdir = _clip(str(tmp_path / "b"), 2)
    ppredict.main(["video", "--frames", fdir, "--masks", mdir, "--out", str(tmp_path / "short"),
                   "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "short")) == ["f0", "f1"]
    assert all(sorted(os.listdir(tmp_path / "short" / f)) == ["00.png", "01.png"]
               for f in ("f0", "f1"))
    monkeypatch.setattr(sys, "argv", ["predict.py", "video", "--frames", fdir, "--masks", mdir,
                                      "--out", str(tmp_path / "jax_short")])
    with pytest.raises(IndexError):
        jpredict.main()

def test_video_first_frame_masks_and_short_clips(video_pair, tmp_path, monkeypatch):
    """Masks for frame 0 only: the flow propagator fills the rest; a clip
    shorter than the window is padded and only its frames are written."""
    _, _, model, _ = video_pair
    monkeypatch.setitem(papp._STATE, "video_model", model)
    fdir, mdir = _clip(str(tmp_path / "a"), 2, masks_for=(0,))
    written, video = papp.inference_video(Args(), fdir, mdir, "flow", str(tmp_path / "out"))
    assert len(written) == 2 and all(os.path.exists(p) for p in written)
    assert video is not None and os.path.splitext(video)[1] in (".mp4", ".gif")


def test_mask_file_segmenter_and_overlay_equal_jax(tmp_path):
    """One PNG per instance, one mask alone, and one label-map PNG."""
    img, paths = _image_and_masks(str(tmp_path))
    lm_path = str(tmp_path / "lm.png")
    Image.fromarray(jseg.MaskFileSegmenter(paths).segment(img)[1]).save(lm_path)
    for ps in (paths, paths[:1], [lm_path]):
        jvis, jlm = jseg.MaskFileSegmenter(ps).segment(img)
        pvis, plm = pseg.MaskFileSegmenter(ps).segment(img)
        assert np.array_equal(plm, jlm) and np.array_equal(np.array(pvis), np.array(jvis))
        jinst, pinst = jseg.label_map_to_instances(jlm), pseg.label_map_to_instances(plm)
        assert len(pinst) == len(jinst) == len(ps) if ps != [lm_path] else len(pinst) == 2
        assert all(np.array_equal(a, b) for a, b in zip(pinst, jinst))
        assert np.array_equal(np.array(pseg._overlay(img, plm)), np.array(jseg._overlay(img, jlm)))


def _moving_frames(n_f=6, h=96, w=128):
    """``tests/test_demo_app.py``'s clip: a textured square moving over a
    textured background, and its first-frame label map."""
    rs = np.random.RandomState(3)
    size, step = 36, 4
    bg = (rs.rand(h, w, 3) * 200).astype(np.uint8)
    patch = (rs.rand(size, size, 3) * 255).astype(np.uint8)
    frames = []
    for t in range(n_f):
        x0, y0 = 8 + step * t, 24 + step * t // 2
        img = bg.copy()
        img[y0:y0 + size, x0:x0 + size] = patch
        frames.append(Image.fromarray(img))
    first = np.zeros((h, w), np.uint8)
    first[24:24 + size, 8:8 + size] = 1
    first[70:90, 90:120] = 2      # a still second instance
    return frames, first


def test_flow_propagator_matches_jax():
    frames, first = _moving_frames()
    want = jseg.FlowPropagator().propagate(frames, first)
    got = pseg.FlowPropagator().propagate(frames, first)
    assert len(got) == len(want) == len(frames)
    for t, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert float((g == w).mean()) >= 0.995, (t, float((g == w).mean()))
    assert (got[-1] == 1).sum() > 0.8 * (first == 1).sum()   # it tracks, not vanishes


def test_flow_pieces_match_cv2():
    """The propagator's setting of the flow, and its grey conversion, remap
    and close, against cv2. The rounded flows agree on 99.5% of the pixels
    (``tests/test_torch_flow.py``'s rule). On one level and three
    iterations the floats agree within 2.4e-7 px. Beyond that, a pixel of
    the top row whose vertical displacement lies within rounding of 0
    samples inside the frame on one side and outside on the other
    (``FarnebackUpdateMatrices``), and the 21x21 box spreads the
    difference: on this pair 0.0141 px at most, 9% of the pixels beyond
    1e-4 px, every rounded flow equal."""
    frames, first = _moving_frames(2)
    g0 = cv2.cvtColor(np.array(frames[0]), cv2.COLOR_RGB2GRAY)
    g1 = cv2.cvtColor(np.array(frames[1]), cv2.COLOR_RGB2GRAY)
    assert np.array_equal(pseg.rgb_to_gray(np.array(frames[0])), g0)
    want = cv2.calcOpticalFlowFarneback(g1, g0, None, 0.5, 4, 21, 5, 5, 1.1, 0)
    got = pseg.farneback_flow(g1, g0, **pseg.FlowPropagator().params)
    assert float((np.rint(got) == np.rint(want)).all(axis=-1).mean()) >= 0.995
    one = dict(pseg.FlowPropagator().params, levels=0, iterations=3)
    assert float(np.abs(pseg.farneback_flow(g1, g0, **one) - cv2.calcOpticalFlowFarneback(
        g1, g0, None, 0.5, 0, 21, 3, 5, 1.1, 0)).max()) < 1e-6
    h, w = g0.shape
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    mx, my = gx + want[..., 0] * 3, gy + want[..., 1] * 3 - 0.5
    assert np.array_equal(pseg.remap_nearest(first, mx, my),
                          cv2.remap(first, mx, my, interpolation=cv2.INTER_NEAREST,
                                    borderMode=cv2.BORDER_CONSTANT, borderValue=0))
    holes = first * (np.random.RandomState(0).rand(h, w) > 0.2)
    holes = holes.astype(np.uint8)
    assert np.array_equal(pseg.morph_close_ellipse(holes, 5),
                          cv2.morphologyEx(holes, cv2.MORPH_CLOSE,
                                           cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))))


def _post_multipart(url, fields):
    boundary = uuid.uuid4().hex
    body = b""
    for name, filename, data in fields:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                 f"filename=\"{filename}\"\r\nContent-Type: image/png\r\n\r\n").encode()
        body += data + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(url, data=body, method="POST", headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    return urllib.request.urlopen(req, timeout=600)


def test_launch_http_round_trip(image_pair, tmp_path, monkeypatch):
    """``launch_http`` on port 0 in a thread: the page, an image request
    (a PNG row of the segmentation and two composites), 404 and 500."""
    _, _, model, _ = image_pair
    monkeypatch.setitem(papp._STATE, "image_model", model)
    img, paths = _image_and_masks(str(tmp_path))
    args = Args()
    args.port = 0
    ready = threading.Event()
    box = {}

    def on_ready(srv):
        box["srv"] = srv
        ready.set()
    thread = threading.Thread(target=papp.launch_http, args=(args, on_ready), daemon=True)
    thread.start()
    assert ready.wait(30)
    url = f"http://127.0.0.1:{box['srv'].server_address[1]}"
    try:
        page = urllib.request.urlopen(url + "/", timeout=30).read().decode()
        assert "action=/image" in page and "action=/video" in page
        buf = io.BytesIO()
        img.save(buf, "PNG")
        fields = [("image", "img.png", buf.getvalue())]
        fields += [("masks", os.path.basename(p), open(p, "rb").read()) for p in paths]
        r = _post_multipart(url + "/image", fields)
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        row = np.array(Image.open(io.BytesIO(r.read())))
        assert row.shape == (64, 64 * 3, 3)
        vis, mattes = papp.inference_image(args, img, paths)
        assert np.array_equal(row, np.concatenate([np.array(vis)] + [np.array(m) for m in mattes],
                                                  axis=1))
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(url + "/nowhere", data=b"x"), timeout=30)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:   # no masks: MaskRCNN's recipe
            _post_multipart(url + "/image", fields[:1])
        assert e.value.code == 500 and "onnxruntime" in e.value.read().decode()
    finally:
        box["srv"].shutdown()
        thread.join(30)
    assert not thread.is_alive()


def test_entry_points_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    img, paths = _image_and_masks(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ppredict.build("configs/maggie_image.yaml", "", video=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppredict.main(["image", "--image", paths[0], "--masks", paths[0], "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.main(["--port", "0"])

    class NoDevice(Args):
        device = None
    papp._STATE.pop("image_model", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.inference_image(NoDevice(), img, paths)
    assert "image_model" not in papp._STATE


def test_external_backends_raise_with_their_recipes():
    for cls, word in ((pseg.XMemPropagator, "XMem"), (pseg.Sam2Propagator, "sam2"),
                      (pseg.MaskRCNNOnnxSegmenter, "onnxruntime")):
        with pytest.raises(RuntimeError, match=word):
            cls()
        assert cls.RECIPE == getattr(jseg, cls.__name__).RECIPE
