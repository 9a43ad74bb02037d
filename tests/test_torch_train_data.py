"""The port's training data (``maggie_tpu_torch/data``, train branch) against
cv2 and against ``maggie_tpu.data`` on the same numpy-seeded inputs.

Everything here is held bit for bit:
- ``data/imgproc.py``'s warp, rectangle morphology, border and JPEG round trip
  against cv2 5.0 (the warp replicates OpenCV 5.0's float kernel on an AVX2
  host; see the module's docstring: each test that holds the warp first
  asserts that cv2 is that build, ``cv2_warp.py``);
- each train transform against the JAX package's, on the same uint8 inputs
  and two ``RandomState`` of one seed: the outputs, and the two states
  afterwards (the port draws what the JAX package draws, in its order);
- the train ``gen_transition_gt`` (one Minkowski-sum pass) against the JAX
  package's iterated cv2 morphology;
- six consecutive ``HIMDataset(is_train=True)`` samples, every key, and the
  dataset's state afterwards;
- the loader's batches over three epochs.
"""

import cv2
import numpy as np
import pytest
from PIL import Image

from cv2_warp import require_cv2_float_warp
from maggie_tpu.data import transforms as JT
from maggie_tpu.data import utils as JU
from maggie_tpu.data.him import HIMDataset as JaxHIM
from maggie_tpu.data.loader import DataLoader as JaxLoader
from maggie_tpu_torch.data import build_dataset, imgproc
from maggie_tpu_torch.data import transforms as PT
from maggie_tpu_torch.data import utils as PU
from maggie_tpu_torch.data.him import HIMDataset
from maggie_tpu_torch.data.loader import DataLoader
from maggie_tpu_torch.ops.morphology import ellipse_sum_runs


def _states_equal(a: np.random.RandomState, b: np.random.RandomState) -> bool:
    sa, sb = a.get_state(), b.get_state()
    return all(np.array_equal(x, y) for x, y in zip(sa, sb))


def _textured(rs, h, w, c=3):
    """A smooth uint8 frame with noise: JPEG and the warp see real texture."""
    base = rs.randint(0, 256, (h // 4 + 2, w // 4 + 2) + ((c,) if c else ())).astype(np.uint8)
    f = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(f.astype(int) + rs.randint(-20, 21, f.shape), 0, 255).astype(np.uint8)


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


def _sample_dict(seed, h=64, w=96, n=3):
    """What the augmentations see after ``Stack``: (1, h, w, 3) frames and
    (n, h, w) uint8 alphas and masks (the masks are the alphas)."""
    rs = np.random.RandomState(seed)
    alphas = np.stack([_blob(h, w, rs.randint(10, w - 10), rs.randint(10, h - 10),
                             rs.randint(8, 24)) for _ in range(n)])
    return {"frames": _textured(rs, h, w)[None], "alphas": alphas, "masks": alphas.copy(),
            "transform_info": []}


def _run_both(make, d, seed):
    """The JAX transform and the port's, each from its own RandomState(seed)."""
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    dj = make(JT, rj)({k: (v.copy() if isinstance(v, np.ndarray) else list(v))
                       for k, v in d.items()})
    dp = make(PT, rp)({k: (v.copy() if isinstance(v, np.ndarray) else list(v))
                       for k, v in d.items()})
    assert _states_equal(rj, rp), "the two RandomStates ended apart"
    for k in ("frames", "alphas", "masks"):
        assert dp[k].dtype == dj[k].dtype and dp[k].shape == dj[k].shape, k
        np.testing.assert_array_equal(dp[k], dj[k], err_msg=k)
    return dp


# ---------------- imgproc against cv2 ----------------

def _affine(rs, h, w):
    """A random map of ``RandomAffine``'s range, centred as ``random_transform`` centres it."""
    th, sh = np.radians(rs.uniform(-10, 10)), np.radians(rs.uniform(-5, 5))
    zx, zy = rs.uniform(0.95, 1.05, 2)
    m = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    m = m @ np.array([[1, -np.sin(sh), 0], [0, np.cos(sh), 0], [0, 0, 1]])
    m = JU._transform_matrix_offset_center(m @ np.diag([zx, zy, 1.0]), h, w)
    cv_m = np.zeros((2, 3))
    cv_m[:, :2] = np.flipud(np.fliplr(m[:2, :2]))
    cv_m[:, 2] = m[:2, 2][::-1]
    return cv_m


@pytest.mark.parametrize("h,w", [(512, 512), (64, 96), (37, 61), (100, 17), (9, 200)])
def test_warp_affine_equals_cv2(h, w):
    """Bilinear uint8 frames and nearest 2-D maps, bit for bit, over maps whose
    width is and is not a multiple of the kernel's 16-wide vector."""
    require_cv2_float_warp()
    rs = np.random.RandomState(h * 1000 + w)
    for _ in range(4):
        m = _affine(rs, h, w)
        frame, alpha = _textured(rs, h, w), rs.randint(0, 256, (h, w)).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.warp_affine(frame, m, (w, h)),
                                      cv2.warpAffine(frame, m, (w, h), flags=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(imgproc.warp_affine(alpha, m, (w, h)),
                                      cv2.warpAffine(alpha, m, (w, h), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 16, 29])
def test_rect_morphology_equals_cv2(k):
    """Rectangles of even and odd size, anchor k // 2, borders ignored."""
    rs = np.random.RandomState(k)
    m = (rs.rand(45, 70) > 0.7).astype(np.uint8)
    m[:3] = 1
    m[:, -2:] = 0
    kern = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(imgproc.dilate_rect(m, k), cv2.dilate(m, kern))
    np.testing.assert_array_equal(imgproc.erode_rect(m, k), cv2.erode(m, kern))


@pytest.mark.parametrize("quality", [20, 50, 79])
def test_jpeg_roundtrip_equals_cv2(quality):
    rs = np.random.RandomState(quality)
    for h, w in ((64, 96), (37, 53)):
        f = _textured(rs, h, w)
        ok, enc = cv2.imencode(".jpg", f[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
        np.testing.assert_array_equal(imgproc.jpeg_roundtrip(f, quality),
                                      cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1])


def test_copy_make_border_equals_cv2():
    rs = np.random.RandomState(0)
    for img in (rs.randint(0, 256, (5, 7, 3)).astype(np.uint8),
                rs.randint(0, 256, (5, 7)).astype(np.uint8)):
        np.testing.assert_array_equal(imgproc.copy_make_border(img, 2, 3, 0, 4),
                                      cv2.copyMakeBorder(img, 2, 3, 0, 4, cv2.BORDER_CONSTANT,
                                                         value=0))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("it", [5, 14])
def test_train_transition_gt_equals_jax(k, it):
    """One pass of the Minkowski-sum element against the JAX package's cv2
    iterations, on alpha-like maps touching every border, with an empty slot."""
    rs = np.random.RandomState(10 * k + it)
    alphas = np.zeros((3, 1, 97, 131), np.float32)
    alphas[0, 0, 10:80, 5:120] = rs.randint(0, 256, (70, 115)) / 255.0
    alphas[0, 0, :4] = rs.randint(0, 256, (4, 131)) / 255.0
    alphas[2, 0] = _blob(97, 131, 128, 3, 30) / 255.0
    masks = (alphas[:, :, ::8, ::8] > 0.5).astype(np.float32)
    got = PU.gen_transition_gt(alphas, masks, k_size=k, iterations=it)
    np.testing.assert_array_equal(got, JU.gen_transition_gt(alphas, masks, k_size=k,
                                                            iterations=it))
    assert got[0].any() and not got[1].any()
    assert ellipse_sum_runs(k, it)[0][0] == -(k // 2) * it


# ---------------- each train transform against the JAX package's ----------------

@pytest.mark.parametrize("padding_prob,hw,crop", [
    (0.0, (64, 96), (48, 48)),      # crop around the alpha
    (0.0, (64, 96), (64, 32)),      # crop of another aspect than cv2's (w, h) size
    (1.0, (64, 96), (48, 48)),      # pad to square (w > h), then resize
    (1.0, (96, 64), (40, 56)),      # pad to square (h > w), ragged size
])
def test_random_crop_by_alpha_equals_jax(padding_prob, hw, crop):
    for seed in range(3):
        d = _sample_dict(seed, *hw)
        if seed == 2:
            d["alphas"][:] //= 3        # nothing above 127: the whole frame is the region
            d["masks"] = d["alphas"].copy()
        _run_both(lambda M, r: M.RandomCropByAlpha(crop, r, padding_prob=padding_prob), d, seed)


@pytest.mark.parametrize("name,make", [
    ("flip", lambda M, r: M.RandomHorizontalFlip(r, 0.5)),
    ("gamma", lambda M, r: M.GammaContrast(r, p=0.7)),
    ("noise", lambda M, r: M.AdditiveGaussianNoise(r, p=0.7)),
    ("jpeg", lambda M, r: M.JpegCompression(r, p=0.7)),
    ("affine", lambda M, r: M.RandomAffine(r, p=0.7)),
    ("down_up", lambda M, r: M.DownUpMask(r, 0.125, 0.7)),
])
def test_frame_transforms_equal_jax(name, make):
    """Eight seeds each: the transform fires at some and not at others."""
    if name == "affine":
        require_cv2_float_warp()
    for seed in range(8):
        _run_both(make, _sample_dict(seed), seed)


def test_jpeg_transform_covers_three_qualities():
    qualities = set()
    for seed in range(8):
        rs = np.random.RandomState(seed)
        if rs.rand() <= 0.7:
            qualities.add(int(100 - rs.uniform(20, 80)))
        _run_both(lambda M, r: M.JpegCompression(r, p=0.7), _sample_dict(seed), seed)
    assert len(qualities) >= 3, qualities


def test_binarized_mask_equals_jax_in_every_order():
    """All four orders, with even and odd dilation and erosion sizes."""
    seen = set()
    for seed in range(16):
        rs = np.random.RandomState(seed)
        for _ in range(3):       # the three masks of one sample draw in turn
            rs.uniform()
            kd, ke = rs.randint(1, 30), rs.randint(1, 30)
            order = rs.choice(["dilate_erode", "erode_dilate", "dilate", "erode"])
            seen.add((str(order), kd % 2, ke % 2))
        _run_both(lambda M, r: M.RandomBinarizedMask(r, 30), _sample_dict(seed), seed)
    for order in ("dilate_erode", "erode_dilate", "dilate", "erode"):
        parities = {(kd, ke) for o, kd, ke in seen if o == order}
        assert len(parities) >= 2, (order, parities)
    assert {kd for _, kd, _ in seen} == {0, 1} and {ke for _, _, ke in seen} == {0, 1}


def test_cut_mask_equals_jax_internal_and_external():
    branches = set()
    for seed in range(10):
        rs = np.random.RandomState(seed)
        branches.add("internal" if rs.rand() < 0.5 else "external")
        _run_both(lambda M, r: M.CutMask(r), _sample_dict(seed), seed)
    assert branches == {"internal", "external"}


def test_load_cache_serves_copies(tmp_path):
    rs = np.random.RandomState(0)
    path = str(tmp_path / "a.png")
    Image.fromarray(rs.randint(0, 256, (8, 9)).astype(np.uint8)).save(path)
    load = PT.Load(cache_gb=1e-6)
    a = load.decode(path, "L")
    a[:] = 0
    b = load.decode(path, "L")
    assert b.any() and load._bytes == b.nbytes
    tiny = PT.Load(cache_gb=1e-9)            # over budget: served fresh, not kept
    tiny.decode(path, "L")
    assert tiny._bytes == 0


# ---------------- the train samples and the loader ----------------

@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """The train layout, root/<split>/images + root/<split>/alphas/<image>/:
    frames of several sizes and aspects, 1 to 5 blob instances; image 1 holds
    5 (over ``max_inst`` 3), and image 2 a tiny instance that is dropped."""
    root = tmp_path_factory.mktemp("him_train")
    rs = np.random.RandomState(0)
    sizes = [(80, 120), (64, 64), (100, 80), (72, 150)]
    for i, (h, w) in enumerate(sizes):
        (root / "tr" / "images").mkdir(parents=True, exist_ok=True)
        Image.fromarray(_textured(rs, h, w)).save(root / "tr" / "images" / f"img{i}.jpg")
        n = 5 if i == 1 else 1 + i % 3
        adir = root / "tr" / "alphas" / f"img{i}"
        adir.mkdir(parents=True)
        for j in range(n):
            a = _blob(h, w, rs.randint(10, w - 10), rs.randint(10, h - 10),
                      1 if (i == 2 and j == 0) else rs.randint(10, 30))
            Image.fromarray(a).save(adir / f"{j:02d}.png")
    return str(root)


_TRAIN_KW = dict(split="tr", short_size=64, crop=(64, 64), max_inst=3, is_train=True,
                 random_seed=5, padding_crop_p=0.3, flip_p=0.5, gamma_p=0.5,
                 add_noise_p=0.5, jpeg_p=0.5, affine_p=0.5, binarized_kernel=30,
                 downscale_mask_p=0.5, alpha_dir_name="alphas", mask_dir_name="")


def test_six_train_samples_equal_jax(train_root, monkeypatch):
    """Samples 0-3, then 1 and 2 again (other draws): the JPEG and the warp
    run in some of them, image 1's five instances are subsampled to three,
    and image 2's one-pixel instance is dropped."""
    require_cv2_float_warp()
    port, ref = HIMDataset(train_root, **_TRAIN_KW), JaxHIM(train_root, **_TRAIN_KW)
    assert [p for p in port.data] == [p for p in ref.data] and len(port) == 4
    calls = {"jpeg_roundtrip": 0, "warp_affine": 0}
    for name in calls:
        def counted(*args, _f=getattr(imgproc, name), _n=name):
            calls[_n] += 1
            return _f(*args)
        monkeypatch.setattr(imgproc, name, counted)
    for i in (0, 1, 2, 3, 1, 2):
        got, want = port[i], ref[i]
        if i == 2:
            assert int(got["alpha"].any(axis=(-1, -2)).sum()) <= 2
        assert set(got) == set(want) == {"image", "mask", "alpha", "transition"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"sample {i} {k}")
        assert got["alpha"].shape == (1, 3, 64, 64) and got["mask"].shape == (1, 3, 8, 8)
        assert _states_equal(port.random, ref.random), f"after sample {i}"
    assert calls["jpeg_roundtrip"] > 0 and calls["warp_affine"] > 0, calls


def test_build_dataset_train_split(train_root):
    from maggie_tpu_torch.config import load_config
    cfg = load_config(None, ["dataset.train.name", "HIM", "dataset.train.root_dir", train_root,
                             "dataset.train.split", "tr", "dataset.train.short_size", "64",
                             "dataset.train.crop", "[64, 64]", "dataset.train.alpha_dir_name", "alphas"])
    ds = build_dataset(cfg, is_train=True, random_seed=3)
    assert ds.is_train and len(ds) == 4 and ds[0]["transition"].shape == (1, 10, 64, 64)


class _Indexed:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"i": i, "x": np.full(2, i, np.float32)}


@pytest.mark.parametrize("batch_size,drop_last,num_shards,shard", [
    (2, True, 1, 0), (3, False, 1, 0), (2, True, 2, 1), (3, True, 3, 2)])
def test_loader_order_over_three_epochs_equals_jax(batch_size, drop_last, num_shards, shard):
    kw = dict(batch_size=batch_size, shuffle=True, drop_last=drop_last, seed=9,
              num_shards=num_shards, shard_index=shard, infinite=True)
    port, ref = DataLoader(_Indexed(), **kw), JaxLoader(_Indexed(), **kw)
    per_epoch = len(port)
    got, want = iter(port), iter(ref)
    for _ in range(3 * per_epoch):
        a, b = next(got), next(want)
        np.testing.assert_array_equal(a["i"], b["i"])
        np.testing.assert_array_equal(a["x"], b["x"])
    n = len(range(shard, 11, num_shards))
    assert per_epoch == (n // batch_size if drop_last else -(-n // batch_size))


def test_loader_finite_epoch_without_shuffle_equals_jax():
    port = [b["i"].tolist() for b in DataLoader(_Indexed(), batch_size=4)]
    assert port == [b["i"].tolist() for b in JaxLoader(_Indexed(), batch_size=4)]
    assert port[-1] == [8, 9, 10]
