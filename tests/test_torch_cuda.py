"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU.

Marked ``cuda``; without a card each test skips. This file imports neither
JAX nor ``maggie_tpu``, so it also runs on a GPU host without them:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both kernels are copies or 0/1 maps: they must equal their twins exactly.
"""

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


def test_compute_unknown_kernel_refuses_wider_elements(card):
    before = ku.launches
    with pytest.raises(ValueError, match="k_size up to 67"):
        ku.compute_unknown(torch.zeros(1, 8, 8, device=card), 68)
    assert ku.launches == before


def test_compute_unknown_kernel_rejects_other_dtypes(card):
    with pytest.raises(TypeError):
        ku.compute_unknown(torch.zeros(1, 8, 8, device=card, dtype=torch.bfloat16), 15)
