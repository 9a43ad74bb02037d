"""The port's eval data pipeline (``maggie_tpu_torch/data``) against cv2 and
against ``maggie_tpu.data`` on the same numpy-seeded inputs.

Tolerances:
- ``data/imgproc.py`` against cv2 5.0: equal bit for bit, downscales and
  upscales alike (the upscales below read 0 pixels off by one grey level), and
  the nearest and fx/fy resizes too;
- ``gen_transition_gt``, ``HIMDataset`` samples (``image`` bit for bit,
  ``mask``, ``alpha``, ``trimap``, ``transform_info``, names) and loader
  batches: equal to the JAX package's;
- the device pipeline against JAX ``device_preprocess_eval``: equal bit for
  bit at ratio 1; with a resize, the image within the JAX file's own bound
  (1.5 grey levels in normalized units, ``tests/test_device_pipeline.py:51``)
  and the masks equal.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from maggie_tpu.data import transforms as JT
from maggie_tpu.data.device_pipeline import device_preprocess_eval as jax_device_tail
from maggie_tpu.data.him import HIMDataset as JaxHIM
from maggie_tpu.data.loader import DataLoader as JaxLoader
from maggie_tpu.data.utils import gen_transition_gt as jax_transition
from maggie_tpu_torch.data import build_dataset, imgproc
from maggie_tpu_torch.data import transforms as PT
from maggie_tpu_torch.data.device_pipeline import device_preprocess_eval
from maggie_tpu_torch.data.him import HIMDataset
from maggie_tpu_torch.data.loader import DataLoader
from maggie_tpu_torch.data.utils import gen_transition_gt

SHORT = 64


def _image(rs, shape, channels):
    return rs.randint(0, 256, shape + ((channels,) if channels == 3 else ())).astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("shape,short", [((720, 1280), 576), ((1080, 1920), 576),
                                         ((600, 900), 576), ((577, 1023), 576),
                                         ((97, 131), 64), ((400, 533), 576),
                                         ((300, 450), 576), ((250, 333), 576)])
def test_resize_linear_equals_cv2(shape, short, channels):
    """The first five are downscales, the last three upscales."""
    img = _image(np.random.RandomState(shape[0]), shape, channels)
    ratio = short / min(shape)
    size = (int(shape[1] * ratio), int(shape[0] * ratio))
    got = imgproc.resize_linear(img, size)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_resize_equals_cv2_at_random_sizes():
    rs = np.random.RandomState(3)
    for _ in range(40):
        h, w = rs.randint(16, 300, 2)
        dh, dw = (int(v) for v in rs.randint(1, 400, 2))
        img = _image(rs, (h, w), int(rs.choice([1, 3])))
        np.testing.assert_array_equal(imgproc.resize_linear(img, (dw, dh)),
                                      cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(
            imgproc.resize_scale(img, 0.125),
            cv2.resize(img, (0, 0), fx=0.125, fy=0.125, interpolation=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(imgproc.resize_nearest(img, (dw, dh)),
                                      cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("src,dst", [(14, 576), (56, 576), (68, 768), (720, 576), (1280, 1024),
                                     (1023, 1021), (577, 576), (640, 80)])
def test_nearest_equals_cv2(src, dst):
    """Includes sizes where ``floor(j * src / dst)`` (the JAX device
    pipeline's map, ``maggie_tpu/data/device_pipeline.py:49-53``) picks
    another source index than cv2 does: 14, 56 and 68."""
    from maggie_tpu.data.device_pipeline import _cv2_nearest_map
    row = np.arange(src, dtype=np.uint16)[None].repeat(2, 0)   # each pixel holds its index
    ref = cv2.resize(row, (dst, 2), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(imgproc.resize_nearest(row, (dst, 2)), ref)
    np.testing.assert_array_equal(imgproc.nearest_index(src, dst), ref[0])
    assert np.array_equal(_cv2_nearest_map(src, dst), ref[0]) == (src not in (14, 56, 68))


def test_pad_and_down_up_mask_equal_jax():
    rs = np.random.RandomState(5)
    masks = ((rs.rand(3, 150, 201) > 0.5) * 255).astype(np.uint8)
    got = PT.DownUpMask(np.random.RandomState(1), 0.125, 1.0)({"masks": list(masks)})["masks"]
    ref = JT.DownUpMask(np.random.RandomState(1), 0.125, 1.0)({"masks": list(masks)})["masks"]
    np.testing.assert_array_equal(got, ref)
    img = _image(rs, (37, 50), 3)
    np.testing.assert_array_equal(imgproc.pad_bottom_right(img, 27, 14),
                                  cv2.copyMakeBorder(img, 0, 27, 0, 14, cv2.BORDER_CONSTANT, value=0))


@pytest.mark.parametrize("k_size", [25, 7, 2])
def test_gen_transition_gt_equals_jax(k_size):
    rs = np.random.RandomState(k_size)
    alphas = (np.round(rs.rand(3, 1, 97, 131) * 255) / 255).astype(np.float32)
    yy, xx = np.mgrid[0:97, 0:131]
    alphas[0, 0] = np.clip((30 - np.hypot(yy - 48, xx - 10)) / 9, 0, 1)   # a blob at the border
    alphas[1] = 0                                                          # an empty slot
    np.testing.assert_array_equal(gen_transition_gt(alphas, k_size=k_size),
                                  jax_transition(alphas, k_size=k_size))


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def him_root(tmp_path_factory):
    """Eval layout (``tests/test_data_him.py:21``): one image already at the
    short size (ratio 1) and two downscaled, with a guidance mask dir."""
    root = tmp_path_factory.mktemp("him_port")
    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate([(SHORT, 90), (96, 128), (150, 100)]):
        (root / "images" / "natural").mkdir(parents=True, exist_ok=True)
        Image.fromarray(_image(rs, (h, w), 3)).save(root / "images" / "natural" / f"img{i}.jpg")
        for j in range(2 + i % 2):
            a = _blob(h, w, 20 + 25 * j, h // 2, min(h, w) // 3)
            for d, arr in (("alphas", a), ("masks", ((a > 100) * 255).astype(np.uint8))):
                (root / d / "natural" / f"img{i}").mkdir(parents=True, exist_ok=True)
                Image.fromarray(arr).save(root / d / "natural" / f"img{i}" / f"{j:02d}.png")
    return str(root)


def _assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    for k in ("image", "mask", "alpha", "trimap"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("image_names", "alpha_names", "transform_info", "skip"):
        assert got[k] == ref[k], k


@pytest.mark.parametrize("mask_dir,downscale", [("masks", False), ("masks", True), ("", True)])
def test_him_dataset_equals_jax(him_root, mask_dir, downscale):
    kw = dict(root_dir=him_root, split="natural", short_size=SHORT, is_train=False,
              downscale_mask=downscale, alpha_dir_name="alphas", mask_dir_name=mask_dir)
    port, ref = HIMDataset(**kw), JaxHIM(**kw)
    assert len(port) == len(ref) == 3
    ratios = []
    for i in range(3):
        s = port[i]
        _assert_samples_equal(s, ref[i])
        ratios.append(s["transform_info"][0]["ratio"])
    assert ratios[0] == 1.0 and ratios[1] < 1.0


def test_loader_batches_equal_jax(him_root):
    kw = dict(root_dir=him_root, split="natural", short_size=SHORT, is_train=False,
              downscale_mask=False, alpha_dir_name="alphas", mask_dir_name="masks")
    port = list(DataLoader(HIMDataset(**kw), batch_size=1))
    ref = list(JaxLoader(JaxHIM(**kw), batch_size=1))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("batch_size,num_shards", [(1, 2), (2, 2), (2, 3)])
def test_loader_shards_equal_jax(batch_size, num_shards):
    """Each process's shard: the same indices, in the same batches, as the JAX
    package's loader gives it; together the shards cover the set once."""
    ds = [{"i": i, "x": np.full(2, i, np.float32)} for i in range(7)]
    seen = []
    for shard in range(num_shards):
        kw = dict(batch_size=batch_size, num_shards=num_shards, shard_index=shard)
        port, ref = DataLoader(ds, **kw), JaxLoader(ds, **kw)
        got, want = list(port), list(ref)
        assert len(port) == len(ref) == len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["i"], b["i"])
            np.testing.assert_array_equal(a["x"], b["x"])
        seen += [int(i) for b in got for i in b["i"]]
    assert sorted(seen) == list(range(7))


def test_loader_raises_what_its_thread_raised():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 1:
                raise ValueError("bad sample 1")
            return {"i": i}

    it = iter(DataLoader(Broken()))
    assert int(next(it)["i"][0]) == 0
    with pytest.raises(ValueError, match="bad sample 1"):
        next(it)


def test_decoder_argument_replaces_pil(him_root, tmp_path):
    """``decode=`` reads another container: the same arrays stored with
    ``np.save`` give the same samples as the PIL-decoded tree."""
    for dirpath, _, files in os.walk(him_root):
        for f in files:
            src = os.path.join(dirpath, f)
            dst = os.path.join(tmp_path, os.path.relpath(src, him_root))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            arr = PT.pil_decode(src, "RGB" if f.endswith(".jpg") else "L")
            with open(dst, "wb") as fh:
                np.save(fh, arr)
    kw = dict(split="natural", short_size=SHORT, is_train=False, downscale_mask=True,
              alpha_dir_name="alphas", mask_dir_name="masks")
    npy = HIMDataset(root_dir=str(tmp_path), decode=lambda p, mode: np.load(p), **kw)
    pil = HIMDataset(root_dir=him_root, **kw)
    for i in range(len(pil)):
        a, b = npy[i], pil[i]
        for k in ("image", "mask", "alpha", "trimap"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_build_dataset_and_what_is_not_ported(him_root):
    from maggie_tpu_torch.config import load_config
    cfg = load_config(None, ["dataset.test.name", "HIM", "dataset.test.root_dir", him_root,
                             "dataset.test.split", "natural", "dataset.test.short_size", str(SHORT),
                             "dataset.test.mask_dir_name", "masks"])
    assert len(build_dataset(cfg, is_train=False)) == 3
    # the train split is indexed split-first (root/<split>/images): none here
    assert len(HIMDataset(him_root, "natural", is_train=True)) == 0
    # the VIM eval set is ported (tests/test_torch_video_engine.py); its train
    # branch is item 11b
    cfg.dataset.train.name = "VIM"
    with pytest.raises(NotImplementedError, match="item 11b"):
        build_dataset(cfg, is_train=True)


def test_device_tail_bit_equal_to_jax_at_ratio_1():
    rs = np.random.RandomState(7)
    frame = _image(rs, (96, 200), 3)                # pads to 128x256
    masks = ((rs.rand(2, 96, 200) > 0.6) * 255).astype(np.uint8)
    img, mask, info = device_preprocess_eval(frame, masks, 96, 64, True, device="cpu")
    jimg, jmask, jinfo = jax_device_tail(frame, masks, 96, 64, True)
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert info == jinfo and info[0]["ratio"] == 1.0


@pytest.mark.parametrize("h0,w0,short", [(240, 320, 160), (200, 150, 128)])
def test_device_tail_with_a_resize(h0, w0, short):
    rs = np.random.RandomState(0)
    frame = _image(rs, (h0, w0), 3)
    masks = ((rs.rand(2, h0, w0) > 0.6) * 255).astype(np.uint8)
    img, mask, info = device_preprocess_eval(frame, masks, short, 64, True, device="cpu")
    jimg, jmask, jinfo = jax_device_tail(frame, masks, short, 64, True)
    tol = (1.0 / 255.0) / 0.224 * 1.5
    assert np.abs(img.numpy() - np.asarray(jimg)).max() < tol
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert info == jinfo


def test_dataset_device_mode_on_the_cpu(him_root):
    """device_preprocess: image and mask are tensors on the given device; the
    metric-side alpha and trimap equal the host path's."""
    kw = dict(root_dir=him_root, split="natural", short_size=SHORT, is_train=False,
              downscale_mask=True, alpha_dir_name="alphas", mask_dir_name="masks")
    host, dev = HIMDataset(**kw), HIMDataset(device_preprocess=True, device="cpu", **kw)
    for i in range(3):
        a, b = host[i], dev[i]
        assert set(a) == set(b)
        np.testing.assert_array_equal(b["mask"].numpy(), a["mask"])
        np.testing.assert_array_equal(b["alpha"], a["alpha"])
        np.testing.assert_array_equal(b["trimap"], a["trimap"])
        assert np.abs(b["image"].numpy() - a["image"]).max() < (1.0 / 255.0) / 0.224 * 1.5
    batch = next(iter(DataLoader(dev, batch_size=1)))
    assert tuple(batch["image"].shape[:2]) == (1, 1) and batch["mask"].shape[:2] == (1, 1)


def test_flagship_cfg_is_the_image_config():
    """``flagship_cfg`` (built in code for hosts without PyYAML) holds
    ``configs/maggie_image.yaml``'s model and eval settings."""
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.flagship import flagship_cfg
    cfg = flagship_cfg()
    ref = load_config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "configs", "maggie_image.yaml"))
    for k in ("arch", "encoder", "encoder_args", "decoder", "aspp", "precision"):
        assert cfg.model[k] == ref.model[k], k
    for k, v in cfg.model.decoder_args.items():
        assert ref.model.decoder_args[k] == v, k
    assert cfg.dataset.test == ref.dataset.test
    for k in ("batch_size", "metrics", "postprocessing", "save_results"):
        assert cfg.test[k] == ref.test[k], k
