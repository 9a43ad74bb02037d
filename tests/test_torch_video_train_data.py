"""The port's VIM training data (``maggie_tpu_torch/data``, video train
branch) against cv2 and against ``maggie_tpu.data`` on numpy-seeded inputs.

Held bit for bit:
- ``gen_diff_mask`` and ``gen_transition_temporal_gt`` against the JAX
  package's cv2 ellipse morphology at widths 2, 3 and 4 (even widths put
  cv2's anchor off centre) and 1 to 6 iterations;
- ``imgproc.line`` against ``cv2.line``;
- ``MaskDropout`` against the JAX package's, with the ``RandomState`` after;
- six consecutive ``VIMDataset(is_train=True)`` clips, every key, with the
  set's ``RandomState`` and numpy's global generator in the same state
  afterwards (the clip sampler and the dilation's iterations draw from the
  global one, in the reference and so on both sides).

``imgproc.filter2d`` computes MotionBlur's correlation exactly, where cv2
sums in float32 (and through a DFT for kernels of 11x11 and more). After
MotionBlur's clip and truncation to uint8 the two differ by at most one
level, on at most ``FILTER_SHARE`` of the pixels (measured on this file's
inputs against cv2 5.0: 730 of 921,600 pixels, 0.079%, over 30 kernels
on random frames; 239 of 884,736, 0.027%, over the MotionBlur stacks). Every later transform is exact,
but the JPEG round trip and the thresholds carry a one-level input change
further, so the whole-clip comparison holds the port against the JAX set
with the JAX side's ``cv2.filter2D`` replaced by the exact correlation (and
once with MotionBlur off and nothing replaced); ``MotionBlur`` itself is
held against the JAX package's unchanged within that bound.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from cv2_warp import require_cv2_float_warp
from maggie_tpu.data import transforms as JT
from maggie_tpu.data import utils as JU
from maggie_tpu.data.vim import VIMDataset as JaxVIM
from maggie_tpu_torch.data import build_dataset, imgproc
from maggie_tpu_torch.data import transforms as PT
from maggie_tpu_torch.data import utils as PU
from maggie_tpu_torch.data.vim import VIMDataset

FILTER_SHARE = 0.01


def _states_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


def _textured(rs, h, w):
    base = rs.randint(0, 256, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
    f = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(f.astype(int) + rs.randint(-20, 21, f.shape), 0, 255).astype(np.uint8)


def _clip_dict(seed, n_f=3, n_i=3, h=64, w=96):
    """A stack after ``Stack``: (n_f, h, w, 3) frames and (n_f * n_i, h, w)
    uint8 alphas of blobs that move a few pixels a frame; masks = alphas."""
    rs = np.random.RandomState(seed)
    centres = [(rs.randint(15, w - 15), rs.randint(15, h - 15), rs.randint(10, 24))
               for _ in range(n_i)]
    alphas = np.stack([_blob(h, w, cx + 3 * t, cy + t, r)
                       for t in range(n_f) for cx, cy, r in centres])
    frames = np.stack([_textured(rs, h, w) for _ in range(n_f)])
    return {"frames": frames, "alphas": alphas, "masks": alphas.copy(), "transform_info": []}


def _exact_filter2d(img, ddepth, kern):
    """``cv2.filter2D``'s signature over the port's exact correlation."""
    return imgproc.filter2d(img[None], kern)[0]


# ---------------- the transition helpers ----------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_gen_diff_mask_equals_jax(k):
    """0/255 change maps touching every border, with an empty map, at 1 to 6
    iterations (VIM train draws 3 to 6)."""
    rs = np.random.RandomState(k)
    maps = np.zeros((4, 1, 53, 71), np.uint8)
    maps[0, 0] = (rs.rand(53, 71) > 0.97) * 255
    maps[1, 0, 0, :] = 255
    maps[1, 0, :, -1] = 255
    maps[3, 0, 20:30, 30:31] = 255
    for it in range(1, 7):
        got = PU.gen_diff_mask(maps, k, it)
        want = JU.gen_diff_mask(maps, k, it)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"k={k} iterations={it}")
        assert not got[2].any() and got[3].sum() > 255 * 10


@pytest.mark.parametrize("k", [2, 3, 4, 25])
def test_gen_transition_temporal_gt_equals_jax(k):
    """Moving soft blobs over four frames, a frame that does not change, and
    the mask disagreement clause on 0/255 masks (which fires)."""
    alphas = np.stack([_blob(48, 64, 20 + 3 * t, 24, 12) for t in range(3)]
                      + [_blob(48, 64, 26, 24, 12)]).astype(np.float32)[:, None] / 255.0
    masks = (alphas[:, :, ::8, ::8] > 0.5).astype(np.float32) * 255
    for it in range(1, 7):
        for m in (None, masks):
            got = PU.gen_transition_temporal_gt(alphas, m, k, it)
            np.testing.assert_array_equal(got, JU.gen_transition_temporal_gt(alphas, m, k, it),
                                          err_msg=f"k={k} iterations={it}")
    assert got[1].any() and not got[3, 0][~(masks[3, 0].repeat(8, 0).repeat(8, 1) > 0)].any()


# ---------------- MotionBlur's line and filter ----------------

def test_line_equals_cv2():
    """Every pair of ends in kernels up to 9x9, and random ends up to 49x49."""
    def both(k, ends):
        a = np.zeros((k, k), np.float32)
        cv2.line(a, ends[:2], ends[2:], 1.0, thickness=1)
        b = imgproc.line(np.zeros((k, k), np.float32), ends[:2], ends[2:], 1.0)
        np.testing.assert_array_equal(b, a, err_msg=f"k={k} ends={ends}")
    for k in (3, 5, 9):
        for ends in np.ndindex(k, k, k, k):
            both(k, tuple(int(v) for v in ends))
    rs = np.random.RandomState(0)
    for _ in range(3000):
        k = rs.randint(3, 50) | 1
        both(k, tuple(int(v) for v in rs.randint(0, k, 4)))


def test_filter2d_within_one_level_of_cv2():
    """The exact correlation against cv2 on uint8 frames, after MotionBlur's
    clip and truncation: at most one level apart, on at most FILTER_SHARE
    of the pixels; a kernel small enough for cv2's direct path included."""
    rs = np.random.RandomState(1)
    off, total = 0, 0
    for case in range(30):
        k = 3 if case == 0 else rs.randint(3, 50) | 1
        kern = np.zeros((k, k), np.float32)
        imgproc.line(kern, *[tuple(int(v) for v in rs.randint(0, k, 2)) for _ in range(2)], 1.0)
        kern = kern / kern.sum()
        img = rs.randint(0, 256, (2, 64, 80, 3)).astype(np.uint8)
        img[:, 10:30, 10:40] = 200          # flat: integer sums, where cv2 may land below
        want = np.stack([np.clip(cv2.filter2D(f.astype(np.float32), -1, kern), 0, 255)
                         for f in img]).astype(np.uint8)
        got = np.clip(imgproc.filter2d(img, kern), 0, 255).astype(np.uint8)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, (k, d.max())
        off += int((d > 0).sum())
        total += d.size
    assert off / total <= FILTER_SHARE, off / total


def test_motion_blur_equals_jax():
    """Eight seeds at p 0.7: the port's MotionBlur against the JAX package's,
    the same draws (RandomState equal afterwards), frames and alphas within
    one level on at most FILTER_SHARE of the pixels; and bit-equal once the
    JAX side's ``cv2.filter2D`` is the exact correlation."""
    fired, off, total = 0, 0, 0
    for seed in range(8):
        d = _clip_dict(seed)
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        dj = JT.MotionBlur(rj, p=0.7)({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                       for k, v in d.items()})
        dp = PT.MotionBlur(rp, p=0.7)({k: (v.copy() if isinstance(v, np.ndarray) else v)
                                       for k, v in d.items()})
        assert _states_equal(rj.get_state(), rp.get_state()), seed
        for k in ("frames", "alphas"):
            assert dp[k].dtype == dj[k].dtype == np.uint8 and dp[k].shape == dj[k].shape
            diff = np.abs(dp[k].astype(int) - dj[k].astype(int))
            assert diff.max() <= 1, (seed, k)
            off += int((diff > 0).sum())
            total += diff.size
        fired += not np.array_equal(dp["frames"], d["frames"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JT.cv2, "filter2D", _exact_filter2d)
            dj = JT.MotionBlur(np.random.RandomState(seed), p=0.7)(
                {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in d.items()})
        for k in ("frames", "alphas"):
            np.testing.assert_array_equal(dp[k], dj[k], err_msg=f"seed {seed} {k}")
    assert fired >= 3 and off / total <= FILTER_SHARE, (fired, off / total)


def test_mask_dropout_equals_jax():
    """Both branches (kept, and boxes zeroed in some of the nine maps), a map
    too small to cut, and an empty map."""
    zeroed = 0
    for seed in range(10):
        d = _clip_dict(seed)
        d["masks"][4] = 0
        d["masks"][7] = 0
        d["masks"][7, 30:36, 40:45] = 255
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        dj = JT.MaskDropout(rj)({"masks": d["masks"].copy()})
        dp = PT.MaskDropout(rp)({"masks": d["masks"].copy()})
        assert _states_equal(rj.get_state(), rp.get_state()), seed
        np.testing.assert_array_equal(dp["masks"], dj["masks"], err_msg=f"seed {seed}")
        zeroed += not np.array_equal(dp["masks"], d["masks"])
    assert 0 < zeroed < 10, zeroed


# ---------------- the train clips ----------------

@pytest.fixture(scope="module")
def vim_train_root(tmp_path_factory):
    """The VIM train layout, root/tr/fgr/<video>/<frame>.jpg and
    root/tr/pha/<video>/<frame>/<instance>.png: two videos of 10 and 7 frames
    at 72x96, three blobs moving a few pixels a frame (video 1's third
    leaves the frame)."""
    root = tmp_path_factory.mktemp("vim_train")
    rs = np.random.RandomState(0)
    h, w = 72, 96
    for v, n_f in enumerate((10, 7)):
        blobs = [(rs.randint(20, w - 20), rs.randint(20, h - 20), rs.randint(10, 20))
                 for _ in range(3)]
        for t in range(n_f):
            os.makedirs(root / "tr" / "fgr" / f"v{v}", exist_ok=True)
            Image.fromarray(_textured(rs, h, w)).save(root / "tr" / "fgr" / f"v{v}" / f"{t:04d}.jpg")
            adir = root / "tr" / "pha" / f"v{v}" / f"{t:04d}"
            adir.mkdir(parents=True)
            for j, (cx, cy, r) in enumerate(blobs):
                step = 9 if (v, j) == (1, 2) else 2
                Image.fromarray(_blob(h, w, cx + step * t, cy + t, r)).save(adir / f"{j:02d}.png")
    return str(root)


_TRAIN_KW = dict(split="tr", short_size=64, crop=(64, 64), max_inst=5, is_train=True,
                 clip_length=3, max_step_size=3, padding_crop_p=0.3, flip_p=0.5, gamma_p=0.5,
                 add_noise_p=0.5, jpeg_p=0.5, affine_p=0.5, binarized_kernel=30,
                 downscale_mask_p=0.5, alpha_dir_name="pha", mask_dir_name="")


def _six_clips(root, seed, motion_p, calls):
    port = VIMDataset(root, random_seed=seed, motion_p=motion_p, **_TRAIN_KW)
    ref = JaxVIM(root, random_seed=seed, motion_p=motion_p, **_TRAIN_KW)
    assert port.frame_ids == ref.frame_ids and len(port) == 8 + 5
    for i in (0, 3, 8, 11, 12, 3):
        np.random.seed(100 + i)
        got = port[i]
        got_global = np.random.get_state()
        np.random.seed(100 + i)
        want = ref[i]
        assert _states_equal(got_global, np.random.get_state()), f"global state after clip {i}"
        assert _states_equal(port.random.get_state(), ref.random.get_state()), f"after clip {i}"
        assert set(got) == set(want) == {"image", "mask", "alpha", "transition"}
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"clip {i} {k}")
        assert got["alpha"].shape == (3, 5, 64, 64) and got["image"].shape == (3, 64, 64, 3)
        assert got["transition"][0].all()
        calls["dropout"] += int(got["alpha"].any(axis=(0, 2, 3)).sum() < 3)


def test_six_train_clips_equal_jax_without_motion_blur(vim_train_root):
    """MotionBlur off, nothing replaced: six clips bit for bit, the JPEG, the
    warp and an instance drop among them."""
    require_cv2_float_warp()
    calls = {"dropout": 0}
    _six_clips(vim_train_root, 5, 0.0, calls)
    assert calls["dropout"] > 0, calls


def test_six_train_clips_equal_jax_with_motion_blur(vim_train_root, monkeypatch):
    """MotionBlur at p 0.7, the JAX side's ``cv2.filter2D`` the exact
    correlation: six clips bit for bit, the blur among them."""
    require_cv2_float_warp()
    calls = {"dropout": 0, "filter2d": 0}

    def counted(*args, _f=imgproc.filter2d):
        calls["filter2d"] += 1
        return _f(*args)
    monkeypatch.setattr(imgproc, "filter2d", counted)
    monkeypatch.setattr(JT.cv2, "filter2D", _exact_filter2d)
    _six_clips(vim_train_root, 2, 0.7, calls)
    assert calls["filter2d"] >= 4, calls


def test_build_dataset_vim_train(vim_train_root):
    """``dataset.train`` of the video config builds the train set: a clip of
    8 from every frame that has 8 to go."""
    from maggie_tpu_torch.config import load_config
    cfg = load_config("configs/maggie_video.yaml", ["dataset.train.root_dir", vim_train_root,
                                                    "dataset.train.split", "tr"])
    ds = build_dataset(cfg, is_train=True, random_seed=3)
    assert isinstance(ds, VIMDataset) and ds.is_train and ds.frame_ids == [("v0", 0), ("v0", 1), ("v0", 2)]
