"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

Marked ``cuda``; without a card each test skips. This file imports neither
JAX nor ``maggie_tpu``, so it also runs on a GPU host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both kernels are copies or 0/1 maps: they must equal their twins exactly.
"""

import os

import numpy as np
import pytest
import torch

from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _indices(rs, n, nby, nbx, cap, n_i):
    """Every corner block first, then random ones; // n_i repeats tiles."""
    corners = [(0, 0), (0, nbx - 1), (nby - 1, 0), (nby - 1, nbx - 1)]
    by = np.array([c[0] for c in corners] + list(rs.randint(0, nby, cap)))[:cap]
    bx = np.array([c[1] for c in corners] + list(rs.randint(0, nbx, cap)))[:cap]
    inst = rs.randint(0, n * n_i, cap)
    return [torch.from_numpy(a.astype(np.int64)) for a in (inst // n_i, by, bx)]


@pytest.mark.parametrize("c,block,halo,dtype", [
    (1, 64, 32, torch.float32), (6, 64, 5, torch.float32), (32, 32, 2, torch.float32),
    (64, 8, 3, torch.bfloat16), (64, 16, 4, torch.bfloat16), (3, 16, 20, torch.float32)])
def test_gather_kernel_equals_twin(card, c, block, halo, dtype):
    rs = np.random.RandomState(c + block)
    n, h, w = 3, 9 * block, 16 * block
    feat = torch.randn(n, h, w, c, generator=torch.Generator().manual_seed(c)).to(card, dtype)
    idx = [t.to(card) for t in _indices(rs, 1, 9, 16, 216, 3)]
    before = kg.launches
    out = kg.gather_patches(feat, *idx, block, halo)
    assert kg.launches == before + 1
    ref = kg.gather_patches_plain(feat, *idx, block, halo)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.equal(out, ref)


# The ladder's five K1 calls at 576x1024 (map shape (N, H, W, C), block, halo)
# in the layout the ladder hands each: x8 and the C=1 mask pixel-major, fea3,
# fea2 and the lazy-os1 input plane-major (the NHWC view of NCHW memory).
MAIN_PATH_GATHERS = [((3, 576, 1024, 1), 64, 32), ((3, 72, 128, 64), 8, 3),
                     ((1, 144, 256, 64), 16, 4), ((1, 288, 512, 32), 32, 2),
                     ((1, 576, 1024, 6), 64, 5)]


def _map(shape, layout, dtype, card, seed=0):
    n, h, w, c = shape
    x = torch.randn(n, c, h, w, generator=torch.Generator().manual_seed(seed)).to(card, dtype)
    x = x.permute(0, 2, 3, 1)
    return x.contiguous() if layout == "pixel" else x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["pixel", "plane"])
@pytest.mark.parametrize("shape,block,halo", MAIN_PATH_GATHERS)
def test_gather_kernel_main_path_layouts_equal_twin(card, shape, block, halo, layout, dtype):
    feat = _map(shape, layout, dtype, card, seed=block)
    assert feat.is_contiguous() == (layout == "pixel" or shape[-1] == 1)
    idx = [t.to(card) for t in _indices(np.random.RandomState(halo), 1, 9, 16, 216, 3)]
    if shape[0] == 3:
        idx[0] = idx[0] * 3 + torch.arange(216, device=card) % 3   # per-instance maps
    before = kg.launches
    out = kg.gather_patches(feat, *idx, block, halo)
    assert kg.launches == before + 1
    ref = kg.gather_patches_plain(feat, *idx, block, halo)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.is_contiguous() and torch.equal(out, ref)


# Plane-major maps whose rows are not 16-byte aligned (bf16 W=1020: 8 bytes
# off; W=1019: 2 bytes), a start address 4 bytes off, and halo > block
@pytest.mark.parametrize("c,block,halo,w,dtype,shift", [
    (6, 64, 5, 1020, torch.bfloat16, 0), (6, 64, 5, 1019, torch.bfloat16, 0),
    (6, 64, 5, 1024, torch.float32, 1), (3, 16, 20, 256, torch.float32, 0),
    (32, 8, 11, 128, torch.bfloat16, 0), (64, 16, 4, 250, torch.float32, 0)])
def test_gather_kernel_plane_major_ragged_equal_twin(card, c, block, halo, w, dtype, shift):
    h = 9 * block
    flat = torch.randn(c * h * w + shift, generator=torch.Generator().manual_seed(c))
    x = flat.to(card, dtype)[shift:].view(1, c, h, w).permute(0, 2, 3, 1)
    idx = [t.to(card) for t in _indices(np.random.RandomState(w), 1, 9, w // block, 216, 3)]
    out = kg.gather_patches(x, *idx, block, halo)
    ref = kg.gather_patches_plain(x, *idx, block, halo)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_gather_kernel_rejects_what_it_does_not_take(card):
    feat = torch.zeros(1, 64, 64, 4, device=card)
    idx = torch.zeros(2, dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        kg.gather_patches(feat.half(), idx, idx, idx, 16, 2)
    with pytest.raises(ValueError):
        kg.gather_patches(feat.permute(0, 2, 1, 3), idx, idx, idx, 16, 2)
    with pytest.raises(ValueError):
        kg.gather_patches(feat[:, ::2], idx, idx, idx, 16, 2)
    with pytest.raises(ValueError):
        kg.gather_patches(feat, idx.int(), idx, idx, 16, 2)


# The video path's five K1 calls of one 3-frame window at 576x1024 with 3
# instances (decoder_video.py through the block ladder on b * n_f = 3 frames):
# the mask and x8 per instance and frame (N = 9), the encoder maps per frame
# (N = 3, entries index frame = map // 3); capacity round(0.5 * 9 * 144) = 648.
VIDEO_PATH_GATHERS = [((9, 576, 1024, 1), 64, 32, "pixel", False),
                      ((9, 72, 128, 64), 8, 3, "pixel", False),
                      ((3, 144, 256, 64), 16, 4, "plane", True),
                      ((3, 288, 512, 32), 32, 2, "plane", True),
                      ((3, 576, 1024, 6), 64, 5, "plane", True)]


# the os1 mask is f32 in both precisions, the features follow the model
@pytest.mark.parametrize("shape,block,halo,layout,per_frame,dtype", [
    g + (dt,) for g in VIDEO_PATH_GATHERS
    for dt in ((torch.float32,) if g[0][-1] == 1 else (torch.float32, torch.bfloat16))])
def test_gather_kernel_video_path_equals_twin(card, shape, block, halo, layout, per_frame, dtype):
    feat = _map(shape, layout, dtype, card, seed=block + 1)
    idx = [t.to(card) for t in _indices(np.random.RandomState(block), 1, 9, 16, 648, 9)]
    idx[0] = torch.arange(648, device=card) % 9     # every map of the window
    if per_frame:
        idx[0] = idx[0] // 3
    before = kg.launches
    out = kg.gather_patches(feat, *idx, block, halo)
    assert kg.launches == before + 1
    ref = kg.gather_patches_plain(feat, *idx, block, halo)
    torch.cuda.synchronize()
    assert out.shape == (648, block + 2 * halo, block + 2 * halo, shape[-1])
    assert out.dtype == dtype and torch.equal(out, ref)


def _speckled(shape, seed):
    """0/1 alphas with a sparse speckle of fractional values, and values
    exactly on the thresholds along one row and one column."""
    rs = np.random.RandomState(seed)
    a = (rs.rand(*shape) > 0.5).astype(np.float32)
    speckle = rs.rand(*shape) < 0.004
    a[speckle] = rs.rand(int(speckle.sum()))
    flat = a.reshape((-1,) + shape[-2:])
    flat[0, 0, :] = np.float32(1 / 255)
    flat[-1, :, 0] = np.float32(254 / 255)
    return a


# (k_size, shape, maps, start offset in floats): the main-path shape with its
# blob alphas at its three widths; ragged W (not a multiple of 4; under 32); H
# under 2 ry + 1; a contiguous view 4 bytes off 16-byte alignment; widths up to
# k=67 (half width 16)
@pytest.mark.parametrize("k_size,shape,maps,shift", [
    (30, (1, 3, 576, 1024), "blob", 0), (27, (1, 3, 576, 1024), "blob", 0),
    (15, (1, 3, 576, 1024), "blob", 0), (30, (2, 3, 300, 530), "speckle", 0),
    (7, (2, 3, 300, 530), "speckle", 0), (2, (2, 3, 300, 530), "speckle", 0),
    (15, (3, 40, 29), "speckle", 0), (67, (2, 20, 150), "speckle", 0),
    (30, (1, 3, 576, 1024), "speckle", 1), (15, (2, 75, 258), "speckle", 3),
    (41, (1, 200, 333), "speckle", 0), (55, (1, 130, 512), "speckle", 0),
    (67, (1, 3, 576, 1024), "speckle", 0)])
def test_compute_unknown_kernel_equals_twin(card, k_size, shape, maps, shift):
    if maps == "blob":
        from maggie_tpu_torch.flagship import blob_alpha
        a = blob_alpha(*shape[-2:], shape[1], np.random.RandomState(k_size))[None]
    else:
        a = _speckled(shape, k_size)
    flat = torch.from_numpy(np.concatenate([np.zeros(shift, np.float32), a.ravel()]))
    ta = flat.to(card)[shift:].view(shape)
    assert ta.is_contiguous() and (ta.data_ptr() % 16 == 0) == (shift % 4 == 0)
    before = ku.launches
    out = ku.compute_unknown(ta, k_size)
    assert ku.launches == before + 1
    ref = ku.compute_unknown_plain(ta, k_size)
    torch.cuda.synchronize()
    assert 0.0 < float(ref.mean()) < 1.0
    assert out.shape == ta.shape and torch.equal(out, ref)


@pytest.mark.parametrize("k_size", [30, 27, 15])
def test_compute_unknown_kernel_video_path_equals_twin(card, k_size):
    """A window's three calls on its 3 frames x 3 instances of blob alphas
    that move between frames (f32: the os8 alpha comes from f32 logits)."""
    from maggie_tpu_torch.flagship import blob_alpha
    frames = [blob_alpha(576, 1024, 3, np.random.RandomState(t)) for t in range(3)]
    a = torch.from_numpy(np.stack(frames)).to(card)              # (3, 3, 576, 1024)
    before = ku.launches
    out = ku.compute_unknown(a, k_size)
    assert ku.launches == before + 1
    ref = ku.compute_unknown_plain(a, k_size)
    torch.cuda.synchronize()
    assert 0.0 < float(ref.mean()) < 1.0 and torch.equal(out, ref)


@pytest.mark.parametrize("k_size", [30, 15])
@pytest.mark.parametrize("shape", [(1, 1, 576, 1024), (1, 10, 576, 1024), (3, 1, 576, 1024),
                                   (3, 10, 576, 1024)])
def test_compute_unknown_kernel_baseline_shapes_equal_twin(card, shape, k_size):
    """The MGM family's fusion calls: one instance or 10 slots, one frame or
    a 3-frame window (the slots past 3 hold mid-range alphas, as a random
    head's are)."""
    from maggie_tpu_torch.flagship import blob_alpha
    rs = np.random.RandomState(k_size + shape[1])
    a = np.stack([blob_alpha(*shape[-2:], 3, rs) for _ in range(shape[0])])[:, :shape[1]]
    if shape[1] > 3:
        a = np.concatenate([a, rs.uniform(0.2, 0.8, (shape[0], shape[1] - 3) + shape[-2:])], 1)
    ta = torch.from_numpy(a.astype(np.float32)).to(card)
    before = ku.launches
    out = ku.compute_unknown(ta, k_size)
    assert ku.launches == before + 1
    ref = ku.compute_unknown_plain(ta, k_size)
    torch.cuda.synchronize()
    assert 0.0 < float(ref.mean()) < 1.0 and torch.equal(out, ref)


@pytest.mark.parametrize("name", ["mgm", "mgm_stacked", "mgm_tcvom", "mgm_stacked_tcvom"])
def test_baseline_eval_on_the_card_matches_cpu(card, name):
    """Each baseline config at full width (seed 0, SN folded) on a 128x256
    frame or 3-frame window with 3 instances, f32 with TF32 off: K2
    launched twice a harness forward (a forward per instance for the
    SingInst archs), K1 never, and the outputs within ``chip_smoke``'s
    phase-3 rule of the CPU port's."""
    import chip_smoke as cs
    from maggie_tpu_torch.ops.kernels import gather as kg
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, model = cs.base_eval_models(name, card)
        n_f = 3 if "tcvom" in name else 1
        alpha = cs.video_alphas(n_f, 128, 256)
        batch = {"image": torch.from_numpy(np.random.RandomState(1).rand(1, n_f, 128, 256, 3)
                                           .astype(np.float32)),
                 "mask": torch.from_numpy((alpha > 0.5).astype(np.float32))}
        k0, u0 = kg.launches, ku.launches
        with torch.inference_mode():
            out = model({k: v.to(card) for k, v in batch.items()})
        torch.cuda.synchronize()
        forwards = 3 if name in cs.BASE_SINGLE else 1
        assert (kg.launches - k0, ku.launches - u0) == (0, 2 * forwards)
        with cs.K2Spy() as spy, torch.inference_mode():
            want = cpu(batch)
        check = cs.base_cpu_check(out, want, spy.band)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert check["refined_masks"]["max_abs_err_outside_flips"] <= cs.REFINED_ATOL, check


@pytest.mark.parametrize("name,b,n_f", [("mgm_stacked", 2, 1), ("mgm_tcvom", 1, 4)])
def test_baseline_train_step_on_the_card_matches_cpu(card, name, b, n_f):
    """One f32 step of ``mgm_stacked`` (batch 2) and ``mgm_tcvom`` (clip 4)
    at 256x256 on the card against the CPU port, within ``chip_smoke``'s
    STEP_* limits (``base_train`` fails otherwise), with no kernel launch."""
    import chip_smoke as cs
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = cs.base_train(name, b, n_f, 256, card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert out["check"]["within"] and not any(out["launches"].values()), out


def test_compute_unknown_kernel_refuses_wider_elements(card):
    before = ku.launches
    with pytest.raises(ValueError, match="k_size up to 67"):
        ku.compute_unknown(torch.zeros(1, 8, 8, device=card), 68)
    assert ku.launches == before


def test_compute_unknown_kernel_rejects_other_dtypes(card):
    """The launch takes f32 only; the wrapper widens bf16 alphas to f32
    first (as the TPU kernel does) and returns the input's dtype."""
    a = torch.rand(2, 40, 136, generator=torch.Generator().manual_seed(0))
    a[0, 5, 7] = 2.0 ** -8 + 2.0 ** -15          # bf16 just above 1/255
    bf = a.to(card, torch.bfloat16)
    with pytest.raises(TypeError):
        ku._launch(bf, 15)
    before = ku.launches
    out = ku.compute_unknown(bf, 15)
    assert ku.launches == before + 1 and out.dtype == torch.bfloat16
    ref = ku.compute_unknown_plain(bf.float(), 15)
    torch.cuda.synchronize()
    assert torch.equal(out.float(), ref)


def test_eval_image_on_the_card(card, tmp_path):
    """``engine.test.eval_image`` on two 160x240 frames (``ResizeShort`` takes
    each to 128x192) with a reduced flagship model: 5 gathers and 3 dilations
    per frame, finite metrics, and each averaged metric within rtol 1e-2 of
    the same run on the CPU (TF32 off; a pixel whose os8 alpha sits on a
    threshold may flip the detail mask on one side only)."""
    import copy
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.data.loader import DataLoader
    from maggie_tpu_torch.engine.test import eval_image, eval_metrics
    from maggie_tpu_torch.flagship import blob_alpha, flagship_cfg
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm

    cfg = flagship_cfg()
    cfg.model.decoder_args.update(dict(atten_dim=32, final_channel=32))
    t = cfg.dataset.test
    t.update(dict(root_dir=str(tmp_path), short_size=128))
    arrays = {}
    for i in range(2):
        rs = np.random.RandomState(i)
        arrays[str(tmp_path / "images" / t.split / f"f{i}.jpg")] = \
            rs.randint(0, 256, (160, 240, 3)).astype(np.uint8)
        for j, a in enumerate(blob_alpha(160, 240, 2, rs)):
            a = np.round(a * 255).astype(np.uint8)
            for d, arr in ((t.alpha_dir_name, a), (t.mask_dir_name, (a > 127).astype(np.uint8) * 255)):
                arrays[str(tmp_path / d / t.split / f"f{i}" / f"{j:02d}.png")] = arr
    for path in arrays:   # HIMDataset indexes the files; ``decode`` reads the arrays
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    cpu_model = fold_spectral_norm(build_model(cfg.model, device="cpu"))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        results = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(cpu_model).to(dev)
            ds = build_dataset(cfg, is_train=False, decode=lambda p, mode: arrays[p])
            metrics = eval_metrics(cfg.test.metrics)
            before = (kg.launches, ku.launches)
            eval_image(model, DataLoader(ds, batch_size=1), 1, metrics)
            torch.cuda.synchronize()
            if dev == "cuda":
                assert (kg.launches - before[0], ku.launches - before[1]) == (10, 6)
            results[dev] = {k: m.average() for k, m in metrics.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert all(np.isfinite(v) for v in results["cuda"].values())
    for k, v in results["cpu"].items():
        assert abs(results["cuda"][k] - v) <= 1e-2 * abs(v), (k, results)


def _train_gather_cases():
    import chip_smoke as cs
    return [case for case in cs.train_gather_cases() if case[-1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _train_gather_cases(), ids=lambda c: c[0])
def test_gather_bwd_kernel_equals_twin_at_train_shapes(card, case, dtype):
    """K1's backward at each differentiable train call of the card condition
    (``chip_smoke.TRAIN_GATHER_CALLS``: per-instance and per-image entries, and
    per-instance maps whose tiles the capacity overflows), in its layout:
    bit-equal to its twin, one launch, ``dfeat`` in the forward's layout."""
    import chip_smoke as cs
    name, shape, block, halo, per_image, layout, _ = case
    idx = cs.train_indices(shape, block, per_image, card, np.random.RandomState(len(name)))
    size = block + 2 * halo
    g = torch.randn((cs.TRAIN_CAP, size, size, shape[-1]), device=card,
                    generator=torch.Generator(device=card).manual_seed(block)).to(dtype)
    plane = layout == "plane"
    before = kg.bwd_launches
    out = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    assert kg.bwd_launches == before + 1
    ref = kg.gather_patches_bwd_plain(g, *idx, shape, block, halo, plane)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.stride() == ref.stride() and torch.equal(out, ref)


def _video_train_gather_cases():
    """(case, dtype) at every K1 call of the video train step (batch 1 x clip
    8 x 512x512, 10 slots: N = 80 maps, cap 2560), in the dtypes it meets."""
    import chip_smoke as cs
    return [(case, dt) for case in cs.train_gather_cases(cs.VIDEO_TRAIN_GATHER_CALLS, False)
            for dt in cs.gather_dtypes(case[1])]


@pytest.mark.parametrize("case,dtype", _video_train_gather_cases(),
                         ids=lambda c: c[0] if isinstance(c, tuple) else str(c)[6:])
def test_gather_kernels_equal_twins_at_video_train_shapes(card, case, dtype):
    """K1 at each call of the video train step in its layout, and its
    backward at each differentiable one: bit-equal to their twins, one
    launch each, ``dfeat`` in the forward's layout."""
    import chip_smoke as cs
    name, shape, block, halo, per_image, layout, grad = case
    idx = cs.train_indices(shape, block, per_image, card, np.random.RandomState(len(name)),
                           cs.VIDEO_TRAIN_CAP)
    feat = cs.gather_map(shape, layout, dtype, card, seed=block)
    before = kg.launches
    out = kg.gather_patches(feat, *idx, block, halo)
    assert kg.launches == before + 1
    assert torch.equal(out, kg.gather_patches_plain(feat, *idx, block, halo))
    if not grad:
        return
    g = torch.randn(out.shape, device=card,
                    generator=torch.Generator(device=card).manual_seed(block)).to(dtype)
    plane = layout == "plane"
    before = kg.bwd_launches
    dfeat = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    assert kg.bwd_launches == before + 1
    ref = kg.gather_patches_bwd_plain(g, *idx, shape, block, halo, plane)
    torch.cuda.synchronize()
    assert dfeat.stride() == ref.stride() and torch.equal(dfeat, ref)


def test_compute_unknown_kernel_video_train_shape_equals_twin(card):
    """K2's call of a video train step: k=30 on 8 frames x 10 slots of f32
    os8 alphas at 512x512, 3 of them discs that move between frames."""
    import chip_smoke as cs
    a = np.zeros((cs.VIDEO_TRAIN_CLIP, cs.TRAIN_SLOTS, cs.TRAIN_HW, cs.TRAIN_HW), np.float32)
    a[:, :cs.N_INST] = cs.video_alphas(cs.VIDEO_TRAIN_CLIP, cs.TRAIN_HW, cs.TRAIN_HW)[0]
    a = torch.from_numpy(a).to(card)
    before = ku.launches
    out = ku.compute_unknown(a, 30)
    assert ku.launches == before + 1
    ref = ku.compute_unknown_plain(a, 30)
    torch.cuda.synchronize()
    assert 0.0 < float(ref.mean()) < 1.0 and torch.equal(out, ref)


def _bwd_edge_cases():
    import chip_smoke as cs
    return cs.BWD_EDGE_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _bwd_edge_cases(), ids=lambda c: c[0])
def test_gather_bwd_kernel_edges_equal_twin(card, case, dtype):
    """K1's backward at the edges of its design (``chip_smoke.BWD_EDGE_CASES``:
    ragged grids, halo = block and halo > block, C = 3 and C = 1, a tile listed
    more times than one staging round holds, neighbourhoods that list no entry,
    entries off the grid, a g off 16-byte alignment, channels split over
    boxes): bit-equal to its twin with the twin's strides, one launch, and the
    same bits from a second run."""
    import chip_smoke as cs
    name, shape, block, halo, layout, *_, shift = case
    g, idx = cs.bwd_edge_inputs(case, dtype, card, len(name))
    assert g.is_contiguous() and (g.data_ptr() % 16 == 0) == (shift == 0)
    plane = layout == "plane"
    before = kg.bwd_launches
    out = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    assert kg.bwd_launches == before + 1
    again = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    ref = kg.gather_patches_bwd_plain(g, *idx, shape, block, halo, plane)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.stride() == ref.stride() and torch.equal(out, ref)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("layout", ["pixel", "plane"])
def test_gather_bwd_kernel_past_32_bit_positions(card, layout):
    """K1's backward on a map of more than 2**31 elements (1 x 8200 x 4096 x
    64 bf16, ragged last tile row): the windows of tiles in the last two tile
    rows land past element 2**31 (pixel-major: the rows below 8192;
    plane-major: every channel plane but the first), and equal the twin on
    the crop that holds them; every other element is zero."""
    shape, block, halo, top = (1, 8200, 4096, 64), 64, 3, 126 * 64
    assert np.prod(shape) > 2**31
    rs = np.random.RandomState(31)
    by = np.concatenate([[128, 128], rs.randint(127, 129, 14)])
    bx = np.concatenate([[0, 63], rs.randint(0, 64, 14)])
    idx = [torch.from_numpy(a.astype(np.int64)).to(card) for a in (np.zeros(16), by, bx)]
    size = block + 2 * halo
    g = torch.randn(16, size, size, 64, generator=torch.Generator().manual_seed(31))
    g = g.to(card, torch.bfloat16)
    plane = layout == "plane"
    out = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    crop = (1, shape[1] - top) + shape[2:]
    ref = kg.gather_patches_bwd_plain(g, idx[0], idx[1] - top // block, idx[2], crop, block,
                                      halo, plane)
    torch.cuda.synchronize()
    n, h, w, c = shape
    assert out.stride() == ((c * h * w, w, 1, h * w) if plane else (h * w * c, w * c, c, 1))
    assert torch.equal(out[:, top:], ref)
    assert int(torch.count_nonzero(out[:, :top])) == 0


def test_gather_autograd_launches_the_backward_kernel(card):
    """A differentiable feature's gradient through the autograd Function on
    the card: one backward launch, none for a gathered mask."""
    feat = torch.randn(2, 64, 64, 8, device=card, requires_grad=True)
    mask = (torch.rand(2, 64, 64, 1, device=card) > 0.5).float()
    idx = [t.to(card) for t in _indices(np.random.RandomState(0), 2, 4, 4, 12, 1)]
    before = kg.bwd_launches
    (kg.gather_patches(feat, *idx, 16, 3) * kg.gather_patches(mask, *idx, 16, 3)).sum().backward()
    assert kg.bwd_launches == before + 1 and feat.grad is not None


def test_gather_bwd_kernel_rejects_what_it_does_not_take(card):
    g = torch.zeros(2, 20, 20, 4, device=card)
    idx = torch.zeros(2, dtype=torch.int64, device=card)
    with pytest.raises(TypeError):
        kg.gather_patches_bwd(g.half(), idx, idx, idx, (1, 64, 64, 4), 16, 2)
    with pytest.raises(ValueError):
        kg.gather_patches_bwd(g[:, ::2], idx, idx, idx, (1, 64, 64, 4), 16, 2)
    with pytest.raises(ValueError):
        kg.gather_patches_bwd(g, idx.int(), idx, idx, (1, 64, 64, 4), 16, 2)


def test_train_step_on_the_card_matches_cpu(card):
    """One f32 ``make_train_step`` step of the full-width model on the card
    against the same step on the CPU (plain twins) at the reduced size
    (batch 2, 256x256, 10 slots), within ``chip_smoke``'s STEP_* limits."""
    import chip_smoke as cs
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        check = cs.card_vs_cpu_step(card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert check["within"], check


def test_video_train_step_on_the_card_matches_cpu(card):
    """One f32 ``make_train_step`` step of the full-width video model on the
    card against the same step on the CPU (plain twins) at the reduced size
    (batch 1 x clip 3 x 256x256, 10 slots), within ``chip_smoke``'s STEP_*
    limits, phase 6's."""
    import chip_smoke as cs
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        check = cs.video_card_vs_cpu_step(card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert check["within"], check


@pytest.mark.parametrize("kind", ["image", "video"])
def test_remat_steps_on_the_card_match_plain(card, kind):
    """One f32 step under ``model.remat`` full and selective on the card
    against the plain step, full width at the reduced size (image batch 2 x
    256x256, video batch 1 x clip 3 x 256x256): within ``chip_smoke``'s
    STEP_* limits, the CUDA generator in the plain step's state after it, and
    one block-index replay checked a remat step (``chip_smoke.remat_compare``)."""
    import chip_smoke as cs
    from maggie_tpu_torch.flagship import train_batch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg, model, init = cs.remat_model(kind, "fp32", card)
        batch = (train_batch(2, 256, 256, 10, seed=1) if kind == "image"
                 else cs.video_train_batch(3, 256, seed=1))
        out = cs.remat_compare(card, cfg, model, init, {k: v.to(card) for k, v in batch.items()})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for mode in ("full", "selective"):
        c = out[mode]
        assert c["within"] and c["generator_equal"] and c["replay_checks"] == 1, (mode, c)


def test_infeed_copies_batches_to_the_card(card):
    """The train infeed's pinned, side-stream copies: each device batch equals
    its host batch once the consumer's stream has waited on its event, and
    ``close()`` ends the producer with batches still queued."""
    from maggie_tpu_torch.engine.infeed import DeviceInfeed
    rs = np.random.RandomState(0)
    batches = [{k: rs.rand(2, 1, 3, 64, 64).astype(np.float32)
                for k in ("image", "mask", "alpha", "transition")} for _ in range(6)]
    feed = DeviceInfeed(iter(batches), card, depth=2)
    for host, dev in feed:
        assert set(dev) == set(host)
        for k, v in dev.items():
            assert v.is_cuda and torch.equal(v.cpu(), torch.from_numpy(host[k]))
    feed.close()
    feed = DeviceInfeed(iter(batches), card, depth=2)
    next(feed)
    feed.close()
    assert not feed._thread.is_alive() and feed._q.empty()


def test_ddp_two_ranks_on_the_card_match_one_process(card, tmp_path):
    """``chip_smoke.py`` phase 11.1 (``chip_smoke.ddp_image``): phase 6's
    image step on two gloo ranks on the card, a row each, plain and under
    ``model.remat selective``, against one process on the global batch
    within the STEP_* limits; the ranks' models equal bit for bit; K1, its
    backward and K2 launched 10 / 6 / 1 (selective 20 / 6 / 2) times a step
    on each rank. TF32 is off for the comparison, as the script sets it."""
    import chip_smoke as cs
    from maggie_tpu_torch.ops.kernels import build
    build.build_all()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        checks, launches = cs.ddp_image(card, str(tmp_path))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert all(c["within"] for c in checks.values()), checks
    assert launches == {"gather_patches": 2 * (10 + 20), "gather_patches_bwd": 2 * (6 + 6),
                        "compute_unknown": 2 * (1 + 2)}


# ---- SparseMat and the dense InstMatt ablation decoder (chip_smoke phase 13)
def test_sparsemat_eval_on_the_card_matches_cpu(card):
    """``sparsemat_image.yaml`` at its widths (seed 0, the LPN's last head
    scaled as in ``chip_smoke`` phase 13) on a 128x256 frame with 2
    instances (a forward each) and ``sparsemat_video.yaml`` on a 3-frame
    clip whose last frame repeats half the one before: no kernel launched,
    an active set neither empty nor full, the alphas within
    ``chip_smoke.REFINED_ATOL`` of the CPU port's (``sm_cpu_check``)."""
    import chip_smoke as cs
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, n_f, n_i in (("sparsemat_image", 1, 2), ("sparsemat_video", 3, 1)):
            cpu, model = cs.sm_eval_models(name, card)
            rs = np.random.RandomState(2)
            img = rs.rand(1, n_f, 128, 256, 3).astype(np.float32)
            img[0, -1, :64] = img[0, max(n_f - 2, 0), :64]
            yy, xx = np.mgrid[0:128, 0:256]
            mask = np.stack([[(yy - 64) ** 2 + (xx - 70 - 100 * j - 3 * t) ** 2 < 40 ** 2
                              for j in range(n_i)] for t in range(n_f)])[None].astype(np.float32)
            batch = {"image": torch.from_numpy(img), "mask": torch.from_numpy(mask)}
            k0, u0 = kg.launches, ku.launches
            with cs.SparsityRecord(keep=True) as rec, torch.inference_mode():
                out = model({k: v.to(card) for k, v in batch.items()})
            torch.cuda.synchronize()
            assert (kg.launches - k0, ku.launches - u0) == (0, 0)
            cs.sm_check_active(name, rec.active)
            with cs.SparsityRecord(keep=True) as cpu_rec, torch.inference_mode():
                want = cpu(batch)
            check = cs.sm_cpu_check(out, want, rec, cpu_rec, name)
            assert check["max_abs_err_held"] <= cs.REFINED_ATOL, (name, check)
            if n_f > 1:
                assert max(rec.shared_share) > 0, rec.shared_share
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("name,b,n_f", [("sparsemat_image", 2, 1), ("sparsemat_video", 1, 3)])
def test_sparsemat_train_step_on_the_card_matches_cpu(card, name, b, n_f):
    """One f32 step of each SparseMat yaml at one slot, 256x256, on the card
    against the CPU port within ``chip_smoke``'s STEP_* limits
    (``sm_check_step`` fails otherwise)."""
    import chip_smoke as cs
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        check = cs.sm_check_step(name, b, n_f, 256, card)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert check["within"], check


def test_sparsemat_dense_decoder_launches_k2(card):
    """The dense InstMatt ablation (``chip_smoke.dense_cfg``) on a 128x256
    frame with 3 instances: K2 three times an eval forward, each call equal
    to its twin, ``detail_mask`` equal to the CPU port's off near-threshold
    pixels; one train step at 2 x 128x128 launches K2 once."""
    import chip_smoke as cs
    from maggie_tpu_torch.flagship import blob_batch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, model = cs.base_eval_models(cs.dense_cfg, card)
        batch = blob_batch(128, 256, 3, 0)
        u0 = ku.launches
        with cs.K2Spy(keep=4) as spy, torch.inference_mode():
            out = model({k: v.to(card) for k, v in batch.items()})
        torch.cuda.synchronize()
        assert ku.launches - u0 == 3 and [k for _, k in spy.k2] == [30, 30, 15]
        for a, k in spy.k2:
            assert torch.equal(ku.compute_unknown(a, k), ku.compute_unknown_plain(a, k))
        with torch.inference_mode():
            want = cpu(batch)
        near, n_diff, unexplained, _ = cs.detail_mask_check(out, want)
        assert unexplained == 0, (near, n_diff)
        # train the unfolded model: a folded spectral norm has no u/v to step
        steps = cs.card_steps(cs.dense_cfg(), cs.base_train_batch(2, 1, 128, 10), card,
                              "dense", steps=1)
        assert steps["launches"] == {"gather_patches": 0, "gather_patches_bwd": 0,
                                     "compute_unknown": 1}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
