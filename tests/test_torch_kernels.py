"""The port's kernel twins and block-sparse ops against the JAX package.

On the CPU the port's wrappers run the plain PyTorch twins of the CUDA
kernels; these must equal the JAX reference EXACTLY (they are copies and 0/1
maps: any difference is a fault). The Pallas kernels run in interpret mode.
The CUDA kernels themselves are tested on the card by ``test_torch_cuda.py``.
"""

import cv2
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from maggie_tpu.ops import blocksparse as jbs
from maggie_tpu.ops.morphology import compute_unknown as jax_compute_unknown
from maggie_tpu.ops.pallas.gather import gather_patches_pallas
from maggie_tpu.ops.pallas.unknown import compute_unknown_pallas
from maggie_tpu_torch.ops import blocksparse as tbs
from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
from maggie_tpu_torch.ops.morphology import _ellipse_row_runs, ellipse_kernel


def _indices(rs, n, nby, nbx, cap, n_i=1):
    """Entries with every corner block first, then random; // n_i repeats tiles."""
    corners = [(0, 0), (0, nbx - 1), (nby - 1, 0), (nby - 1, nbx - 1)]
    by = np.array([c[0] for c in corners] + list(rs.randint(0, nby, cap)))[:cap]
    bx = np.array([c[1] for c in corners] + list(rs.randint(0, nbx, cap)))[:cap]
    inst = rs.randint(0, n * n_i, cap)
    return [a.astype(np.int64) for a in (inst // n_i, by, bx)]


# (C, block, halo, n_i, dtype): the ladder's geometries at reduced sizes --
# the C=1 os1 mask (block 64, halo 32), the 6-channel lazy-os1 input (64, 5),
# fea2 (32, 2) -- with per-image repeated tiles (n_i > 1) and bf16
@pytest.mark.parametrize("c,block,halo,n_i,dtype", [
    (1, 64, 32, 1, np.float32),
    (6, 64, 5, 3, np.float32),
    (32, 32, 2, 3, np.float32),
    (32, 32, 2, 3, jnp.bfloat16),
])
def test_gather_plain_matches_jax(c, block, halo, n_i, dtype):
    rs = np.random.RandomState(c + block)
    n, h, w = 2, 128, 192
    feat = rs.randn(n, h, w, c).astype(np.float32)
    idx = _indices(rs, n, h // block, w // block, 9, n_i)
    jfeat = jnp.asarray(feat).astype(dtype)
    ref = np.asarray(jbs._gather_patches_xla(jfeat, *map(jnp.asarray, idx), block, halo)
                     .astype(jnp.float32))
    if c == 1:  # the TPU route for C=1 masks: 4x4 packing around the Pallas kernel
        pal = jbs._gather_mask_via_packed(jfeat, *map(jnp.asarray, idx), block, halo,
                                          lambda *a: gather_patches_pallas(*a, interpret=True))
    else:
        pal = gather_patches_pallas(jfeat, *map(jnp.asarray, idx), block, halo, interpret=True)
    np.testing.assert_array_equal(np.asarray(pal.astype(jnp.float32)), ref)
    tfeat = torch.from_numpy(feat).to(torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    tidx = [torch.from_numpy(a) for a in idx]
    for fn in (kg.gather_patches_plain, kg.gather_patches, tbs.gather_patches):
        out = fn(tfeat, *tidx, block, halo)
        assert out.dtype == tfeat.dtype and out.shape == (9, block + 2 * halo,
                                                          block + 2 * halo, c)
        np.testing.assert_array_equal(out.float().numpy(), ref)


def _alpha(rs, shape, p=0.004):
    """0/1 alphas with a sparse speckle of fractional values, so that the
    dilated map has structure (a dense speckle would dilate to all ones)."""
    a = (rs.rand(*shape) > 0.5).astype(np.float32)
    speckle = rs.rand(*shape) < p
    a[speckle] = rs.rand(int(speckle.sum())).astype(np.float32)
    return a


def _cv2_unknown(alpha, width):
    unc = ((alpha > 1 / 255) & (alpha < 254 / 255)).astype(np.uint8)
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (width, width))
    flat = unc.reshape((-1,) + alpha.shape[-2:])
    return np.stack([cv2.dilate(m, se) for m in flat]).reshape(alpha.shape)


@pytest.mark.parametrize("k_size", [30, 27, 15])
def test_compute_unknown_plain_matches_jax_and_cv2(k_size):
    rs = np.random.RandomState(k_size)
    alpha = _alpha(rs, (1, 3, 64, 96))
    alpha[0, 0, 5, 7] = np.float32(1 / 255)          # exactly on the thresholds
    alpha[0, 0, 9, 11] = np.float32(254 / 255)
    xla = np.asarray(jax_compute_unknown(jnp.asarray(alpha), k_size=k_size, is_train=False))
    pal = np.asarray(compute_unknown_pallas(jnp.asarray(alpha), k_size=k_size, interpret=True))
    np.testing.assert_array_equal(pal, xla)
    np.testing.assert_array_equal(xla.astype(np.uint8), _cv2_unknown(alpha, k_size // 2))
    ta = torch.from_numpy(alpha)
    for fn in (ku.compute_unknown_plain, ku.compute_unknown):
        out = fn(ta, k_size)
        assert out.dtype == torch.float32 and 0.05 < float(out.mean()) < 0.95
        np.testing.assert_array_equal(out.numpy(), xla)


def test_compute_unknown_plain_multi_chunk(monkeypatch):
    """A map the Pallas kernel cuts into several row chunks (as at 576x1024),
    with uncertainty bands across every chunk boundary."""
    import maggie_tpu.ops.pallas.unknown as pu

    orig = pu._row_chunk
    monkeypatch.setattr(pu, "_row_chunk",
                        lambda H, W, halo, budget_bytes=2 << 20: orig(H, W, halo, budget_bytes=1))
    rs = np.random.RandomState(2)
    alpha = _alpha(rs, (2, 72, 136))
    for k_size in (30, 15):
        pal = np.asarray(compute_unknown_pallas(jnp.asarray(alpha), k_size=k_size,
                                                interpret=True))
        out = ku.compute_unknown_plain(torch.from_numpy(alpha), k_size).numpy()
        np.testing.assert_array_equal(out, pal)
        np.testing.assert_array_equal(out.astype(np.uint8), _cv2_unknown(alpha, k_size // 2))


def _kernel_emulation(alpha, k_size, tile_w=128, tile_h=32):
    """numpy emulation of csrc/compute_unknown.cu: per tile, one 64-bit row
    mask per staged column, a horizontal OR widened over the nested extents and
    one shift-OR per row run."""
    runs = ku._sorted_runs(k_size // 2)
    ry = max(abs(r[0]) for r in runs)
    rx = max(max(-r[1], r[2]) for r in runs)
    lo, hi = np.float32(ku._LO), np.float32(ku._HI)
    m, h, w = alpha.shape
    out = np.zeros_like(alpha)
    for z in range(m):
        for y0 in range(0, h, tile_h):
            for x0 in range(0, w, tile_w):
                cols = []
                for c in range(tile_w + 2 * rx):
                    x, bits = x0 - rx + c, 0
                    for j in range(tile_h + 2 * ry):
                        y = y0 - ry + j
                        if 0 <= x < w and 0 <= y < h and lo < alpha[z, y, x] < hi:
                            bits |= 1 << j
                    cols.append(bits)
                for t in range(min(tile_w, w - x0)):
                    hbits = acc = 0
                    ca, cb = 0, -1
                    for dy, a, b in runs:
                        for d in range(a, b + 1):
                            if ca > cb or d < ca or d > cb:
                                hbits |= cols[t + rx + d]
                        ca, cb = a, b
                        acc |= hbits >> (ry + dy)
                    for y in range(min(tile_h, h - y0)):
                        out[z, y0 + y, x0 + t] = (acc >> y) & 1
    return out


@pytest.mark.parametrize("k_size", [30, 15])
def test_kernel_algorithm_matches_plain(k_size):
    """The CUDA kernel's bit-column algorithm (tile seams included) gives the
    twin's map; the run order it needs nests for every width up to the 33 the
    kernel's 64-bit masks allow."""
    rs = np.random.RandomState(5)
    alpha = _alpha(rs, (1, 40, 150))
    ref = ku.compute_unknown_plain(torch.from_numpy(alpha), k_size).numpy()
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(_kernel_emulation(alpha, k_size), ref)
    for width in range(1, 34):
        runs = ku._sorted_runs(width)
        assert len(runs) == max(int(ellipse_kernel(width).any(axis=1).sum()), 1)
        assert max(abs(r[0]) for r in runs) <= 16
    assert _ellipse_row_runs(15)[0] == (-7, 0, 0)


def test_select_blocks_ties_and_overflow_match_jax():
    """Massive ties (every block fully active, or equal counts) and capacity
    overflow: the stable descending sort picks lax.top_k's blocks in its order."""
    rs = np.random.RandomState(0)
    n, h, w, blk = 3, 32, 48, 8
    maps = [np.ones((n, h, w), np.float32),                       # all tie
            (rs.rand(n, h, w) > 0.5).astype(np.float32),          # scattered
            np.zeros((n, h, w), np.float32)]                      # nothing active
    maps[1][:, :8, :] = 1.0                                       # tied full blocks
    for mask in maps:
        for cap in (1, 10, 36, 60):                               # 36 = all blocks
            ref = jbs.select_blocks(jnp.asarray(mask), blk, cap)
            got = tbs.select_blocks(torch.from_numpy(mask), blk, cap)
            for r, g in zip(ref, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_scatter_blocks_matches_jax():
    rs = np.random.RandomState(1)
    n, h, w, c, blk = 2, 64, 96, 3, 16
    mask = np.zeros((n, h, w), np.float32)
    mask[rs.randint(0, n, 20), rs.randint(0, h, 20), rs.randint(0, w, 20)] = 1.0
    cap = 30                                                      # > the active tiles
    idx = jbs.select_blocks(jnp.asarray(mask), blk, cap)
    assert not bool(np.asarray(idx[3]).all())                     # some invalid entries
    cores = rs.randn(cap, blk, blk, c).astype(np.float32)
    ref = jbs.scatter_blocks(jnp.asarray(cores), *idx, (n, h, w, c), fill=-99.0)
    tidx = [torch.from_numpy(np.array(a)) for a in idx]
    got = tbs.scatter_blocks(torch.from_numpy(cores), *tidx, (n, h, w, c), fill=-99.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
