"""The cv2 replicas that mask generation needs (``maggie_tpu_torch/data/imgproc.py``)
against cv2 5.0, and the seven transforms that no dataset uses
(``maggie_tpu_torch/data/transforms.py``) against ``maggie_tpu.data.transforms``,
on the CPU at small sizes (96x128).

Every comparison is exact: the replicas' outputs equal cv2's bit for bit
(contours point for point and in cv2's list order, moments as float64), and
each transform's outputs equal the JAX package's under the same
``RandomState`` and the same global ``np.random`` seed, with both generators'
states equal afterwards.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

import maggie_tpu.data.transforms as J
import maggie_tpu_torch.data.transforms as P
from maggie_tpu_torch.data import imgproc

H, W = 96, 128


def _blob(h, w, cx, cy, r):
    d = np.hypot(*np.mgrid[0:h, 0:w] - np.array([cy, cx])[:, None, None])
    return (np.clip((r - d) / max(r * 0.3, 1), 0, 1) * 255).astype(np.uint8)


def _ellipses(rs, h, w, n, fill=(255,)):
    img = np.zeros((h, w), np.uint8)
    for _ in range(n):
        cv2.ellipse(img, (int(rs.randint(-5, w + 5)), int(rs.randint(-5, h + 5))),
                    (int(rs.randint(0, 40)), int(rs.randint(0, 40))), float(rs.rand() * 180),
                    0, 360, int(rs.choice(fill)), -1)
    return img


@pytest.mark.parametrize("shape", [cv2.MORPH_RECT, cv2.MORPH_ELLIPSE])
def test_structuring_element_matches_cv2(shape):
    for w in range(1, 14):
        for h in range(1, 14):
            want = cv2.getStructuringElement(shape, (w, h))
            got = imgproc.structuring_element(shape, (w, h))
            assert got.dtype == want.dtype and np.array_equal(got, want), (w, h)


@pytest.mark.parametrize("op", ["dilate", "erode"])
def test_morphology_matches_cv2(op):
    """Random 0/255 maps, elements of every shape ``_get_random_structure``
    draws (even sizes: off-centre anchors) and arbitrary 0/1 kernels."""
    rs = np.random.RandomState(0)
    ours, theirs = getattr(imgproc, op), getattr(cv2, op)
    for t in range(120):
        img = ((rs.rand(rs.randint(1, 40), rs.randint(1, 40)) < rs.rand()) * 255).astype(np.uint8)
        size = rs.randint(3, 10)
        for k in (cv2.getStructuringElement(cv2.MORPH_RECT, (size, size)),
                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)),
                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, max(size // 2, 1))),
                  cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (max(size // 2, 1), size))):
            assert np.array_equal(ours(img, k), theirs(img, k)), (t, k.shape)
        k = (rs.rand(rs.randint(1, 8), rs.randint(1, 8)) < 0.5).astype(np.uint8)
        k.flat[rs.randint(k.size)] = 1
        assert np.array_equal(ours(img, k), theirs(img, k)), (t, k.tolist())


def test_morphology_of_a_view_reads_nothing_outside_it():
    """``_perturb_seg`` hands cv2 the slice ``seg[ly:lh, lx:lw]``: cv2 treats it
    as a map of its own (no pixel outside the view is read), and so does the
    replica."""
    rs = np.random.RandomState(1)
    for _ in range(100):
        img = ((rs.rand(40, 50) < 0.3) * 255).astype(np.uint8)
        ly, lx = rs.randint(0, 40), rs.randint(0, 50)
        lh, lw = rs.randint(ly + 1, 41), rs.randint(lx + 1, 51)
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (rs.randint(3, 10), rs.randint(1, 10)))
        view = img[ly:lh, lx:lw]
        for op in ("dilate", "erode"):
            alone = getattr(cv2, op)(view.copy(), k)
            assert np.array_equal(getattr(cv2, op)(view, k), alone)
            assert np.array_equal(getattr(imgproc, op)(view, k), alone)


def _contour_cases():
    rs = np.random.RandomState(2)
    holes = np.zeros((H, W), np.uint8)
    cv2.rectangle(holes, (10, 10), (100, 80), 255, -1)
    for c in ((30, 30), (60, 40), (80, 60)):
        cv2.circle(holes, c, 8, 0, -1)
    nested = np.zeros((H, W), np.uint8)
    for i, r in enumerate((45, 35, 25, 15, 5)):
        cv2.circle(nested, (64, 48), r, 255 if i % 2 == 0 else 0, -1)
    edge = np.zeros((H, W), np.uint8)
    edge[:20, :] = 255
    edge[:, -15:] = 255
    edge[60:, :30] = 255
    edge[50:70, 60:90] = 255
    singles = np.zeros((H, W), np.uint8)
    singles[rs.randint(0, H, 40), rs.randint(0, W, 40)] = 255
    singles[0, 0] = singles[-1, -1] = singles[0, -1] = 255
    lines = np.zeros((H, W), np.uint8)
    lines[10, 5:100] = 255
    lines[20:90, 50] = 255
    cv2.line(lines, (5, 90), (120, 30), 255, 1)
    cv2.line(lines, (0, 0), (40, 95), 255, 1)
    lines[30:60, 100:102] = 255
    noise = [((rs.rand(H, W) < p) * 255).astype(np.uint8) for p in (0.1, 0.5, 0.9)]
    blobs = [_ellipses(rs, H, W, rs.randint(1, 8), (0, 255, 255)) for _ in range(20)]
    for b in blobs:
        b[rs.rand(H, W) < 0.02] ^= 255
    return {"holes": [holes], "nested": [nested], "edge_touching": [edge],
            "single_pixels": [singles], "lines": [lines], "noise": noise, "blobs": blobs,
            "full_and_empty": [np.full((H, W), 255, np.uint8), np.zeros((H, W), np.uint8),
                               np.full((1, 1), 7, np.uint8), np.full((1, 9), 1, np.uint8)]}


CONTOUR_CASES = _contour_cases()


@pytest.mark.parametrize("case", sorted(CONTOUR_CASES))
def test_find_contours_matches_cv2(case):
    """The same contours, in cv2's list order, each from the same start in the
    same direction, point for point; and their moments as float64."""
    for img in CONTOUR_CASES[case]:
        want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
        got = imgproc.find_contours_list(img)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            assert g.dtype == c.dtype and g.shape == c.shape and np.array_equal(g, c)
            m = cv2.moments(c)
            assert imgproc.contour_moments(g) == {k: m[k] for k in ("m00", "m10", "m01")}


def test_find_contours_at_full_resolution():
    """720x1280, six overlapping ellipses and noise: equal to cv2."""
    rs = np.random.RandomState(3)
    img = _ellipses(rs, 720, 1280, 6, (255,))
    img[rs.rand(720, 1280) < 0.001] ^= 255
    want, _ = cv2.findContours(img.copy(), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    got = imgproc.find_contours_list(img)
    assert len(got) == len(want) and all(np.array_equal(g, c) for g, c in zip(got, want))


def test_contour_moments_of_polygons_match_cv2():
    """Either orientation, self-intersecting, collinear (zero area) and short
    point lists."""
    rs = np.random.RandomState(4)
    polys = [rs.randint(0, 300, (rs.randint(1, 30), 1, 2)).astype(np.int32) for _ in range(200)]
    polys += [np.array([[[0, 0]], [[5, 5]], [[10, 10]]], np.int32),
              np.array([[[3, 4]]], np.int32), np.array([[[0, 0]], [[4, 0]]], np.int32)]
    for p in polys:
        m = cv2.moments(p)
        assert imgproc.contour_moments(p) == {k: m[k] for k in ("m00", "m10", "m01")}


def _fill_cases():
    rs = np.random.RandomState(5)
    cases = []
    for _ in range(60):   # random polygons: self-intersecting, overlapping, degenerate
        h, w = rs.randint(5, 80), rs.randint(5, 80)
        cases.append(((h, w), [np.stack([rs.randint(0, w, n), rs.randint(0, h, n)], 1)
                               .astype(np.int32).reshape(-1, 1, 2)
                               for n in rs.randint(1, 12, rs.randint(1, 4))]))
    for _ in range(40):   # what ModifyMaskBoundary draws: subsampled contours of blobs
        img = _ellipses(rs, H, W, rs.randint(1, 6), (0, 255, 255))
        contours, _ = cv2.findContours(img, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
        cases.append(((H, W), [c[np.sort(rs.choice(len(c), max(1, len(c) // rs.randint(1, 15)),
                                                   replace=False))] for c in contours]))
    edge = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]], np.int32).reshape(-1, 1, 2)
    cases.append(((H, W), [edge, edge[::-1].copy()]))
    cases.append(((H, W), [np.array([[[5, 5]]], np.int32), np.array([[[9, 3]], [[9, 40]]], np.int32)]))
    return cases


def test_fill_contours_matches_cv2():
    for i, (shape, contours) in enumerate(_fill_cases()):
        want = cv2.drawContours(np.zeros(shape, np.uint8), contours, -1, (255, 0, 0), -1)
        got = imgproc.fill_contours(shape, contours)
        assert got.dtype == np.uint8 and np.array_equal(got, want), i


@pytest.mark.parametrize("k", [5, 15, 25])
def test_gaussian_blur_u8_matches_cv2(k):
    """Every sigma ``LoadRandomBackground`` draws, on RGB and grey images,
    one smaller than the kernel (the reflection folds more than once)."""
    rs = np.random.RandomState(6)
    for sigma in (1.0, 1.5, 3.0, 5.0):
        for shape in ((H, W, 3), (37, 53, 3), (8, 9, 3), (30, 41)):
            img = rs.randint(0, 256, shape).astype(np.uint8)
            assert np.array_equal(imgproc.gaussian_blur_u8(img, k, sigma),
                                  cv2.GaussianBlur(img, (k, k), sigma)), (sigma, shape)


def test_pngs_and_jpegs_decode_as_cv2_reads_them(tmp_path):
    """The tool writes its masks with PIL: they decode (with PIL or cv2) to the
    arrays ``cv2.imwrite`` writes. A JPEG background decodes with PIL to
    ``cv2.imread``'s pixels (channels reversed): the cv2 5.0 and PIL builds
    the tests run with both link libjpeg-turbo."""
    rs = np.random.RandomState(7)
    mask = ((rs.rand(H, W) < 0.4) * 255).astype(np.uint8)
    Image.fromarray(mask).save(tmp_path / "pil.png")
    cv2.imwrite(str(tmp_path / "cv2.png"), mask)
    for name in ("pil.png", "cv2.png"):
        assert np.array_equal(cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE), mask)
        assert np.array_equal(P.pil_decode(str(tmp_path / name), "L"), mask)
    photo = np.asarray(Image.fromarray(rs.randint(0, 256, (24, 32, 3)).astype(np.uint8))
                       .resize((W * 2, H * 2), Image.BILINEAR))
    for q, sub in ((75, 2), (95, 0)):
        Image.fromarray(photo).save(tmp_path / "bg.jpg", quality=q, subsampling=sub)
        assert np.array_equal(P.pil_decode(str(tmp_path / "bg.jpg"), "RGB"),
                              cv2.imread(str(tmp_path / "bg.jpg"))[:, :, ::-1])


def _sample(seed, n=2, masks=True):
    rs = np.random.RandomState(seed)
    frames = [rs.randint(0, 256, (H, W, 3)).astype(np.uint8) for _ in range(n)]
    alphas = [_blob(H, W, rs.randint(30, W - 30), rs.randint(30, H - 30), rs.randint(14, 34))
              for _ in range(n)]
    d = {"frames": frames, "alphas": alphas, "transform_info": []}
    if masks:
        d["masks"] = [((a > 127) * 255).astype(np.uint8) for a in alphas]
    return d


def _copy(d):
    return {k: ([x.copy() for x in v] if isinstance(v, list) else
                v.copy() if isinstance(v, np.ndarray) else v) for k, v in d.items()}


def _run_both(make, d, seed):
    """Each side's transform (``make(module, RandomState)``) on its own copy of
    ``d``, from the same ``RandomState(seed)`` and global seed; returns the
    two outputs and the two sides' generator states."""
    outs, states = [], []
    for mod in (J, P):
        rs = np.random.RandomState(seed)
        np.random.seed(seed + 1000)
        outs.append(make(mod, rs)(_copy(d)))
        states.append((rs.get_state(), np.random.get_state()))
    return outs, states


def _assert_equal(a, b, label):
    assert a.keys() == b.keys(), label
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y), (label, k)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and np.array_equal(u, v), (label, k)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (label, k)
        else:
            assert x == y, (label, k)


def _assert_states(states, label):
    (jr, jg), (pr, pg) = states
    for a, b in ((jr, pr), (jg, pg)):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and a[2:] == b[2:], label


def _bg_files(tmp):
    """A PNG larger than the frames, a JPEG larger and a PNG smaller (upscaled)."""
    rs = np.random.RandomState(8)
    paths = []
    for name, (h, w) in (("big.png", (150, 200)), ("big.jpg", (130, 170)), ("small.png", (60, 70))):
        img = np.asarray(Image.fromarray(rs.randint(0, 256, (h // 4, w // 4, 3)).astype(np.uint8))
                         .resize((w, h), Image.BILINEAR))
        path = os.path.join(tmp, name)
        Image.fromarray(img).save(path, **({"quality": 90} if name.endswith(".jpg") else {}))
        paths.append(path)
    return paths


TRANSFORMS = ("ChooseOne", "RandomCenterCrop", "MasksFromBinarizedAlpha", "LoadRandomBackground",
              "ComposeBackground", "ModifyMaskBoundary", "HistogramMatching")


@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(name, tmp_path):
    """Several seeds each, so that every branch runs (asserted where a branch
    depends on a draw)."""
    bgs = _bg_files(str(tmp_path))
    seen = set()
    for seed in range(12):
        d = _sample(seed, masks=name != "MasksFromBinarizedAlpha" or seed % 2 == 0)
        if name == "ChooseOne":
            def make(m, rs):
                return m.ChooseOne(rs, [m.RandomCenterCrop(rs), m.MasksFromBinarizedAlpha(0.3)])
        elif name == "RandomCenterCrop":
            def make(m, rs):
                return m.RandomCenterCrop(rs)
        elif name == "MasksFromBinarizedAlpha":
            def make(m, rs):
                return m.MasksFromBinarizedAlpha(0.25 + 0.05 * seed)
        elif name == "LoadRandomBackground":
            def make(m, rs):
                return m.LoadRandomBackground(bgs, rs)
        elif name == "ComposeBackground":
            rs = np.random.RandomState(seed)
            d["fg"] = np.asarray(d["frames"]).astype(np.float32)
            d["bg"] = rs.randint(0, 256, (2, H, W, 3)).astype(np.float32)

            def make(m, rs):
                return m.ComposeBackground()
        elif name == "ModifyMaskBoundary":
            d["masks"] = np.stack(d["masks"])

            def make(m, rs):
                return m.ModifyMaskBoundary(rs, p=0.3)
        else:
            rs = np.random.RandomState(seed)
            d["fg"] = np.asarray(d["frames"]).astype(np.float32)
            d["bg"] = rs.randint(0, 256, (2, H, W, 3)).astype(np.float32)

            def make(m, rs):
                return m.HistogramMatching(rs, p=0.9)
        (jax_out, port_out), states = _run_both(make, d, seed)
        _assert_equal(jax_out, port_out, (name, seed))
        _assert_states(states, (name, seed))
        if name == "LoadRandomBackground":
            seen.add(jax_out["bg"].shape)
            probe = np.random.RandomState(seed)
            probe.randint(3)
            seen.add("blur" if probe.rand() < 0.5 else "plain")
        elif name == "HistogramMatching":
            seen.add("fg" if "fg" in jax_out and jax_out["fg"].dtype == np.uint8 else
                     "bg" if jax_out["bg"].dtype == np.uint8 else "kept")
        elif name == "ModifyMaskBoundary":
            seen.add("walked" if not np.array_equal(jax_out["masks"], d["masks"]) else "kept")
    want = {"LoadRandomBackground": {"blur", "plain", (2, H, W, 3)},
            "HistogramMatching": {"fg", "kept"},
            "ModifyMaskBoundary": {"walked", "kept"}}.get(name, set())
    assert want <= seen, seen


def test_modify_mask_boundary_on_a_full_size_mask():
    """720x1280, as the tool runs it (``p`` 0): equal, global draws included."""
    rs = np.random.RandomState(9)
    mask = _ellipses(rs, 720, 1280, 3, (255,))
    (jax_out, port_out), states = _run_both(
        lambda m, r: (lambda d: {"masks": m.ModifyMaskBoundary(r, p=0.0)._modify(d["masks"])}),
        {"masks": mask}, 11)
    assert np.array_equal(jax_out["masks"], port_out["masks"])
    assert not np.array_equal(jax_out["masks"], mask)
    _assert_states(states, "full size")


def test_histogram_matching_takes_the_background_branch():
    """The 5% branch (``bg`` matched to ``fg``) at a seed that draws it."""
    for seed in range(200):
        rs = np.random.RandomState(seed)
        rs.rand(), rs.uniform(0, 0.5)
        if rs.rand() < 0.05:
            break
    d = _sample(seed)
    d["fg"] = np.asarray(d["frames"]).astype(np.float32)
    d["bg"] = np.random.RandomState(seed).randint(0, 256, (2, H, W, 3)).astype(np.float32)
    (jax_out, port_out), states = _run_both(lambda m, rs: m.HistogramMatching(rs, p=1.0), d, seed)
    assert jax_out["bg"].dtype == np.uint8
    _assert_equal(jax_out, port_out, seed)
    _assert_states(states, seed)
