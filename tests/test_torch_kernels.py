"""The port's kernel twins and block-sparse ops against the JAX package.

On the CPU the port's wrappers run the plain PyTorch twins of the CUDA
kernels; these must equal the JAX reference EXACTLY (they are copies and 0/1
maps: any difference is a fault). The Pallas kernels run in interpret mode.
The CUDA kernels themselves are tested on the card by ``test_torch_cuda.py``.
"""

import re
from pathlib import Path

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


# (C, block, halo, n_i, dtype): the ladder's five geometries at reduced sizes --
# the C=1 os1 mask (block 64, halo 32), x8 (64, 8, 3), fea3 (64, 16, 4), fea2
# (32, 32, 2), the 6-channel lazy-os1 input (64, 5) -- with per-image repeated
# tiles (n_i > 1), in f32 and bf16. Each map goes in both layouts the kernel
# reads: contiguous NHWC, and the NHWC view of NCHW memory (plane-major), as
# the ladder hands it fea3, fea2 and the lazy-os1 input.
@pytest.mark.parametrize("c,block,halo,n_i,dtype", [
    (1, 64, 32, 1, np.float32),
    (6, 64, 5, 3, np.float32),
    (32, 32, 2, 3, np.float32),
    (32, 32, 2, 3, jnp.bfloat16),
    (1, 64, 32, 1, jnp.bfloat16),
    (6, 64, 5, 3, jnp.bfloat16),
    (64, 8, 3, 1, np.float32),
    (64, 8, 3, 1, jnp.bfloat16),
    (64, 16, 4, 3, np.float32),
    (64, 16, 4, 3, jnp.bfloat16),
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
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    pixel = torch.from_numpy(feat).to(tdt)
    plane = torch.from_numpy(np.ascontiguousarray(feat.transpose(0, 3, 1, 2))).to(tdt)
    plane = plane.permute(0, 2, 3, 1)
    assert c == 1 or not plane.is_contiguous()
    tidx = [torch.from_numpy(a) for a in idx]
    for tfeat in (pixel, plane):
        for fn in (kg.gather_patches_plain, kg.gather_patches, tbs.gather_patches):
            out = fn(tfeat, *tidx, block, halo)
            assert out.dtype == tfeat.dtype and out.is_contiguous()
            assert out.shape == (9, block + 2 * halo, block + 2 * halo, c)
            np.testing.assert_array_equal(out.float().numpy(), ref)


def _train_indices(rs, n, nby, nbx, cap, n_i, overflow):
    """select_blocks' entries: distinct (instance, by, bx) tiles in random
    order, // n_i for per-image maps; with ``overflow`` the instances have
    fewer tiles than ``cap`` and the rest repeat tile 0, as select_blocks pads."""
    tiles = rs.permutation(n * n_i * nby * nbx)[:cap]
    if overflow:
        assert len(tiles) < cap
    tiles = np.concatenate([tiles, np.zeros(cap - len(tiles), np.int64)])
    inst, rem = tiles // (nby * nbx), tiles % (nby * nbx)
    return [a.astype(np.int64) for a in (inst // n_i, rem // nbx, rem % nbx)]


# (n, h, w, C, block, halo, n_i, cap, layout): the train ladder's six
# differentiable gathers at reduced sizes -- x8 (block 8, halo 3), fea3 (16, 4,
# per image), the os4 hand-off (16, 1), fea2 (32, 0, per image), the os2
# hand-off (32, 2), fea1 (64, 3, per image) -- and capacities past the tile
# count (the padding entries repeat tile 0); then halo = block and halo > block
# (reach 1 and 2: the JAX VJP's scatter-add branch), and capacities past
# n_tiles * dup_bound with dup_bound > 1 (the same branch).
_BWD_CASES = [
    (6, 24, 32, 8, 8, 3, 1, 9, "pixel"),
    (2, 48, 64, 16, 16, 4, 3, 14, "plane"),
    (6, 48, 64, 8, 16, 1, 1, 10, "pixel"),
    (2, 64, 96, 8, 32, 0, 3, 12, "plane"),
    (6, 64, 96, 8, 32, 2, 1, 20, "pixel"),
    (2, 128, 128, 4, 64, 3, 3, 10, "plane"),
    (2, 24, 32, 8, 8, 3, 1, 30, "pixel"),
    (1, 64, 96, 8, 32, 2, 1, 9, "plane"),
    (2, 32, 48, 8, 8, 8, 1, 12, "pixel"),
    (2, 32, 48, 4, 8, 8, 3, 14, "plane"),
    (2, 32, 48, 8, 8, 11, 1, 12, "plane"),
    (2, 32, 48, 4, 8, 11, 3, 20, "pixel"),
    (1, 32, 32, 8, 16, 2, 3, 20, "pixel"),
    (1, 32, 32, 8, 16, 2, 3, 20, "plane"),
]


@pytest.mark.parametrize("n,h,w,c,block,halo,n_i,cap,layout", _BWD_CASES)
def test_gather_bwd_plain_matches_jax_vjp(n, h, w, c, block, halo, n_i, cap, layout):
    """K1's backward twin against ``jax.vjp`` of the JAX package's gather with
    ``dup_bound`` n_i (its routed strips, and its scatter-add fallback past
    that bound): 1e-6 relative to the largest element, the two summing
    duplicate windows in another order. The autograd Function's gradient is
    the twin's, in the layout the forward read; bf16 rounds the twin's f32
    sum once."""
    import jax
    rs = np.random.RandomState(n * h + c + halo)
    nby, nbx = h // block, w // block
    overflow = cap > n * n_i * nby * nbx
    idx = _train_indices(rs, n, nby, nbx, cap, n_i, overflow)
    feat = rs.randn(n, h, w, c).astype(np.float32)
    size = block + 2 * halo
    g = rs.randn(cap, size, size, c).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jbs.gather_patches(x, *map(jnp.asarray, idx), block, halo, n_i),
                     jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tidx = [torch.from_numpy(a) for a in idx]
    plane = layout == "plane"
    got = kg.gather_patches_bwd_plain(torch.from_numpy(g), *tidx, (n, h, w, c), block, halo, plane)
    assert got.shape == (n, h, w, c)
    assert got.permute(0, 3, 1, 2).is_contiguous() if plane else got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())

    tfeat = torch.from_numpy(feat)
    if plane:
        tfeat = tfeat.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    tfeat.requires_grad_()
    kg.gather_patches(tfeat, *tidx, block, halo).backward(torch.from_numpy(g))
    assert torch.equal(tfeat.grad, got) and tfeat.grad.stride() == got.stride()

    gb = torch.from_numpy(g).to(torch.bfloat16)
    got_bf = kg.gather_patches_bwd_plain(gb, *tidx, (n, h, w, c), block, halo, plane)
    ref_bf = kg.gather_patches_bwd_plain(gb.float(), *tidx, (n, h, w, c), block, halo, plane)
    assert got_bf.dtype == torch.bfloat16 and torch.equal(got_bf, ref_bf.to(torch.bfloat16))


@pytest.mark.parametrize("layout,n_i,cap", [("pixel", 1, 7), ("plane", 2, 12), ("pixel", 1, 20)])
def test_gather_autograd_gradcheck(layout, n_i, cap):
    """``torch.autograd.gradcheck`` of the gather's autograd Function in
    float64 on the CPU (plain twins both ways), with repeated tiles and a
    capacity past the tile count (fast mode: random projections of the
    Jacobian, not each of its columns)."""
    rs = np.random.RandomState(cap)
    n, h, w, c, block, halo = 2, 16, 24, 3, 8, 3
    idx = [torch.from_numpy(a) for a in
           _train_indices(rs, n, 2, 3, cap, n_i, cap > n * n_i * 6)]
    feat = torch.from_numpy(rs.randn(n, h, w, c))
    if layout == "plane":
        feat = feat.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    feat.requires_grad_()
    assert torch.autograd.gradcheck(lambda x: kg.gather_patches(x, *idx, block, halo), (feat,),
                                    fast_mode=True)


def test_gather_backward_runs_only_for_inputs_that_need_it(monkeypatch):
    """A gathered mask (no grad) beside a gathered feature: one backward call,
    for the feature."""
    calls = []
    bwd = kg.gather_patches_bwd
    monkeypatch.setattr(kg, "gather_patches_bwd", lambda *a, **k: calls.append(a[4]) or bwd(*a, **k))
    rs = np.random.RandomState(0)
    idx = [torch.from_numpy(a) for a in _train_indices(rs, 2, 2, 2, 5, 1, False)]
    feat = torch.randn(2, 16, 16, 4, requires_grad=True)
    mask = (torch.rand(2, 16, 16, 1) > 0.5).float()
    out = kg.gather_patches(feat, *idx, 8, 2) * kg.gather_patches(mask, *idx, 8, 2)
    out.sum().backward()
    assert calls == [(2, 16, 16, 4)] and feat.grad is not None


def test_gather_bwd_plain_on_a_ragged_grid_equals_index_put():
    """The twin on a grid whose edge tiles are cut (H, W not multiples of the
    block), with repeated, padding and off-grid entries, against a direct
    ``index_put_(accumulate=True)`` of every on-grid window into a zero-padded
    map, in float64 (the JAX VJP takes ``h // block`` tiles, so it cannot be
    the reference here). Both layouts."""
    rs = np.random.RandomState(5)
    n, h, w, c, block, halo, cap = 3, 50, 75, 4, 16, 5, 40
    nby, nbx = -(-h // block), -(-w // block)
    idx = [rs.randint(0, n, cap), rs.randint(0, nby, cap), rs.randint(0, nbx, cap)]
    idx[1][:4], idx[2][:4] = nby - 1, nbx - 1                   # the cut corner tile, 4 times
    idx[0][4], idx[1][5], idx[2][6] = n, -1, nbx                # off the grid
    idx = [torch.from_numpy(a.astype(np.int64)) for a in idx]
    size = block + 2 * halo
    g = torch.from_numpy(rs.randn(cap, size, size, c))
    on = ((idx[0] >= 0) & (idx[0] < n) & (idx[1] >= 0) & (idx[1] < nby)
          & (idx[2] >= 0) & (idx[2] < nbx))
    ar = torch.arange(size)
    padded = torch.zeros(n, nby * block + 2 * halo, nbx * block + 2 * halo, c, dtype=g.dtype)
    padded.index_put_((idx[0][on][:, None, None], (idx[1][on] * block)[:, None, None] + ar[:, None],
                       (idx[2][on] * block)[:, None, None] + ar), g[on], accumulate=True)
    want = padded[:, halo:halo + h, halo:halo + w]
    for plane in (False, True):
        got = kg.gather_patches_bwd_plain(g, *idx, (n, h, w, c), block, halo, plane)
        assert got.shape == (n, h, w, c) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


_BWD_CU = (Path(kg.__file__).parent / "csrc" / "gather_patches_bwd.cu").read_text()


def _bwd_const(name):
    """A ``constexpr int`` of the backward kernel's source (a number or a product)."""
    a, b = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", _BWD_CU).groups()
    return int(a) * int(b or 1)


def _gather_bwd_kernel_emulation(g, idx, shape, block, halo, plane, g_addr=0):
    """numpy emulation of csrc/gather_patches_bwd.cu's work plan: the index
    pass (arrivals in an arbitrary order, as the atomics give them, the scan,
    the unordered placement, then each entry's move to its rank among its
    tile's lower entries), then the pull's boxes (the host's box shape and
    instance choice, each block's owned vectors, its neighbour filter and window
    list in the contract's order, each window's masked 16-byte reads with their
    f32 adds) and its stores: pixel-major straight from the sums, plane-major
    through the turn buffer. It asserts that every vector access is aligned,
    that the staged list equals a stable sort of the keys, that the turn fits
    in the ring and that each output element is written once. Returns the f32
    sums in the (N, H, W, C) view of the kernel's layout, and (K, vector out,
    whether a box listed more windows than one staging round holds, the box's
    columns)."""
    threads, windows = _bwd_const("kThreads"), _bwd_const("kWindows")
    n_maps, h, w, c = shape
    esize = g.element_size()
    gf = g.float().numpy().reshape(-1)
    cap, size = g.shape[0], block + 2 * halo
    nby, nbx = -(-h // block), -(-w // block)
    n_tiles = n_maps * nby * nbx
    i_n, i_y, i_x = (t.numpy() for t in idx)
    ok = (i_n >= 0) & (i_n < n_maps) & (i_y >= 0) & (i_y < nby) & (i_x >= 0) & (i_x < nbx)
    keys = np.where(ok, (i_n * nby + i_y) * nbx + i_x, -1)
    assert (cap * n_tiles < 2**31) or cap == 0                  # the packed tile * cap + arrival
    arrival, seen = np.zeros(cap, np.int64), np.zeros(n_tiles, np.int64)
    for p in np.random.RandomState(cap).permutation(cap):       # the atomics' order
        if ok[p]:
            arrival[p], seen[keys[p]] = seen[keys[p]], seen[keys[p]] + 1
    starts = np.concatenate([[0], np.cumsum(seen)]).astype(np.int64)
    unordered = np.full(int(ok.sum()), -1, np.int64)
    unordered[starts[keys[ok]] + arrival[ok]] = np.flatnonzero(ok)
    assert (unordered >= 0).all()
    lst = np.full(unordered.shape, -1, np.int64)
    for i, p in enumerate(unordered):
        t = np.searchsorted(starts, i, side="right") - 1          # the kernel's binary search
        seg = unordered[starts[t]:starts[t + 1]]
        lst[starts[t] + int((seg < p).sum())] = p
    np.testing.assert_array_equal(lst, np.flatnonzero(ok)[np.argsort(keys[ok], kind="stable")])

    k16 = 16 // esize
    vec = c % k16 == 0 and g_addr % 16 == 0
    kk = k16 if vec else 1
    box = threads * (_bwd_const("kVectors") * k16 if vec else _bwd_const("kElements"))
    ring = box * esize * _bwd_const("kStages")
    cc_ = min(c, box)
    wc = min(block, box // cc_)
    r = min(block, box // (wc * cc_))
    if r == block and wc == block:                               # whole tiles side by side
        wc = block * max(1, min(box // (block * block * cc_), nbx))
    span = max(wc, block)
    cper, rper = -(-span // wc), -(-block // r)
    nbr, nbc, nbch = nby * rper, -(-w // span) * cper, -(-c // cc_)
    vec_out = w % k16 == 0 and block % k16 == 0 and wc % k16 == 0
    e_n = box // threads // kk
    reach = -(-halo // block)
    out = np.zeros(n_maps * h * w * c, np.float32)
    written = np.zeros(out.shape, np.int64)
    vec_idx = np.arange(threads)[:, None] + np.arange(e_n)[None, :] * threads
    most = 0                                                     # windows of one box
    for blk in range(n_maps * nbr * nbc * nbch):
        b, bch = divmod(blk, nbch)
        b, bc = divmod(b, nbc)
        n, br = divmod(b, nbr)
        ty, gcol = br // rper, bc // cper
        y0 = ty * block + br % rper * r
        y1 = min(y0 + r, ty * block + block, h)
        xa = gcol * span + bc % cper * wc
        x1 = min(xa + wc, gcol * span + span, w)
        c0 = bch * cc_
        if y0 >= y1 or xa >= x1:
            continue
        c1 = min(c0 + cc_, c)
        f = vec_idx * kk
        y, x, ch = y0 + (f // cc_) // wc, xa + (f // cc_) % wc, c0 + f % cc_
        valid = (y < y1) & (x < x1) & (ch < c1)
        acc = np.zeros(vec_idx.shape + (kk,), np.float32)
        wins = []
        sy0, sx0 = y0 // block - reach, xa // block - reach
        nsx = (x1 - 1) // block - xa // block + 1 + 2 * reach
        for nb in range(((y1 - 1) // block - y0 // block + 1 + 2 * reach) * nsx):
            sy, sx = sy0 + nb // nsx, sx0 + nb % nsx
            wy, wx = sy * block - halo, sx * block - halo
            if (0 <= sy < nby and 0 <= sx < nbx and wy < y1 and wy + size > y0
                    and wx < x1 and wx + size > xa):
                t = (n * nby + sy) * nbx + sx
                wins += [(p, wy, wx) for p in lst[starts[t]:starts[t + 1]]]
        most = max(most, len(wins))
        for p, wy, wx in wins:
            ry, rx = y - wy, x - wx
            inside = valid & (ry >= 0) & (ry < size) & (rx >= 0) & (rx < size)
            src = p * size * size * c + (ry * size + rx) * c + ch
            assert ((g_addr + src[inside] * esize) % (kk * esize) == 0).all()
            acc[inside] += gf[src[inside][:, None] + np.arange(kk)]
        if not plane:
            dst = (((n * h + y) * w + x) * c + ch)[valid]
            assert (dst * esize % (kk * esize) == 0).all()
            for k in range(kk):
                out[dst + k] = acc[valid][:, k]
                written[dst + k] += 1
            continue
        stride = r * wc + 1
        assert cc_ * stride * esize <= ring
        turn = np.full(cc_ * stride, np.nan, np.float32)
        at = ((ch - c0) * stride + (y - y0) * wc + (x - xa))[valid]
        for k in range(kk):
            turn[at + k * stride] = acc[valid][:, k]
        ko = k16 if vec_out else 1
        nv = wc // ko
        i = np.arange(cc_ * r * nv)
        xv, t = i % nv, i // nv
        yy, xx, cch = y0 + t % r, xa + xv * ko, c0 + t // r
        keep = (yy < y1) & (xx < x1) & (cch < c1)
        src = ((cch - c0) * stride + (yy - y0) * wc + (xx - xa))[keep]
        dst = (((n * c + cch) * h + yy) * w + xx)[keep]
        assert (dst * esize % (ko * esize) == 0).all()
        for k in range(ko):
            assert not np.isnan(turn[src + k]).any()
            out[dst + k] = turn[src + k]
            written[dst + k] += 1
    assert (written == 1).all()
    view = out.reshape(n_maps, c, h, w).transpose(0, 2, 3, 1) if plane else \
        out.reshape(n_maps, h, w, c)
    return view, (kk, vec_out, most > windows, wc)


# The train ladder's box shapes at reduced map sizes (chip_smoke.BWD_EDGE_CASES's
# row format): x8's one box per tile, fea3's and the os4 hand-off's 4-row boxes,
# fea1's 2-row boxes with per-image repeats.
_BWD_PLAN_TRAIN = (
    ("x8", (4, 32, 32, 64), 8, 3, "pixel", 40, "random", 0),
    ("fea3", (1, 64, 48, 64), 16, 4, "plane", 30, "random", 0),
    ("x4", (4, 48, 48, 64), 16, 1, "pixel", 30, "random", 0),
    ("fea1", (1, 128, 128, 32), 64, 3, "plane", 12, "random", 0),
)


def _bwd_plan_cases():
    import chip_smoke as cs
    return list(cs.BWD_EDGE_CASES + _BWD_PLAN_TRAIN)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", _bwd_plan_cases(), ids=lambda c: c[0])
def test_gather_bwd_kernel_plan_matches_plain(case, dtype):
    """The CUDA backward's work plan gives the twin's dfeat bit for bit at
    every edge case the card tests hold (ragged grids, halo >= block, C = 1
    and 3, lists longer than one staging round, empty neighbourhoods, off-grid
    entries, a misaligned g, channels split over boxes, boxes of two tiles)
    and at the train ladder's box shapes, and takes the 16-byte instance where
    it should."""
    import chip_smoke as cs
    name, shape, block, halo, layout, *_, shift = case
    g, idx = cs.bwd_edge_inputs(case, dtype, "cpu", len(name))
    plane = layout == "plane"
    got, (k, vec_out, rounds, box_cols) = _gather_bwd_kernel_emulation(
        g, idx, shape, block, halo, plane, g_addr=g.data_ptr() % 16)
    ref = kg.gather_patches_bwd_plain(g, *idx, shape, block, halo, plane)
    assert torch.equal(torch.from_numpy(np.ascontiguousarray(got)).to(dtype), ref)
    k16 = 16 // g.element_size()
    assert k == (k16 if shape[-1] % k16 == 0 and not shift else 1)
    if name in ("x8", "fea3", "x4", "fea1"):
        assert k == k16 and (vec_out or not plane)
    assert rounds == name.startswith("long_list")
    if name in ("tiles_per_box", "tiles_per_box_plane", "x8"):    # 8x8x64 tiles
        assert box_cols == (2 * block if dtype == torch.bfloat16 else block)


_GATHER_CU = (Path(kg.__file__).parent / "csrc" / "gather_patches.cu").read_text()


def _cu_const(name):
    """A ``constexpr int`` of the kernel source (a number or a product of two)."""
    a, b = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", _GATHER_CU).groups()
    return int(a) * int(b or 1)


def _fast_div(d):
    """(mul, shift) of the kernel's FastDiv for the divisor d."""
    shift = max(int(d - 1).bit_length(), 0)
    return (((1 << shift) - d) << 32) // d + 1, shift


def _fast_quotient(n, div):
    mul, shift = div
    assert 0 <= n < 1 << 31
    return (((n * mul) >> 32) + n) >> shift


def test_fast_division_is_exact():
    """The kernel's multiply-and-shift division equals n // d for the divisors
    and dividends it meets (C and S up to 4096, n below 2^31)."""
    rs = np.random.RandomState(0)
    ns = np.concatenate([np.arange(0, 5000), rs.randint(0, 1 << 31, 2000),
                         [(1 << 31) - 1, (1 << 31) - 2]])
    for d in list(range(1, 300)) + [511, 512, 513, 1000, 4095, 4096]:
        div = _fast_div(d)
        assert div[0] < 1 << 32
        assert all(_fast_quotient(int(n), div) == int(n) // d for n in ns), d


def _gather_kernel_emulation(mem, shape, strides, idx, block, halo, esize, feat_addr=0,
                             out_addr=0):
    """numpy emulation of csrc/gather_patches.cu's work plan on the raw elements
    ``mem`` of a map (N, H, W, C) addressed by ``strides``: the host's choice of
    layout and vector width (from the addresses and strides), the thread blocks'
    bands of rows, the in-map span of each row, the 16-byte-aligned staging span
    with its zero chunks, and the plane-major band's scalar head and tail around
    its 16-byte stores. It asserts that every vector access is aligned and that
    each output element is written exactly once."""
    threads, rows_per_thread = _cu_const("kThreads"), _cu_const("kRowsPerThread")
    stage_bytes, bands_per_block = _cu_const("kStageBytes"), _cu_const("kBandsPerBlock")
    n_maps, h, w, c = shape
    sn, sy, sx, sc = strides
    size = block + 2 * halo
    k16 = 16 // esize
    cap = idx[0].shape[0]
    out = np.zeros(cap * size * size * c, mem.dtype)
    written = np.zeros(out.shape, np.int64)
    if sc == 1 and sx == c and sy == w * c:                      # pixel-major
        vec = (feat_addr % 16 == 0 and out_addr % 16 == 0 and (size * c) % k16 == 0
               and sy % k16 == 0 and sn % k16 == 0 and (block * c) % k16 == 0
               and (halo * c) % k16 == 0)
        k = k16 if vec else 1
        row_vecs = size * c // k
        tx = min(-(-row_vecs // 32) * 32, threads)
        rows = threads // tx * rows_per_thread
        for p in range(cap):
            n = int(idx[0][p])
            x0 = int(idx[2][p]) * block - halo
            v_lo = (max(x0, 0) - x0) * c // k
            v_hi = max((min(x0 + size, w) - x0) * c // k, v_lo)
            for r0 in range(0, size, rows):                      # blockIdx.y
                for r in range(r0, min(r0 + rows, size)):
                    y = int(idx[1][p]) * block - halo + r
                    dst = (p * size + r) * size * c
                    for v in range(row_vecs):
                        d = dst + v * k
                        assert (out_addr + d * esize) % (k * esize) == 0
                        written[d:d + k] += 1
                        if 0 <= n < n_maps and 0 <= y < h and v_lo <= v < v_hi:
                            src = n * sn + x0 * c + y * sy + v * k
                            assert (feat_addr + src * esize) % (k * esize) == 0
                            out[d:d + k] = mem[src:src + k]
        assert (written == 1).all()
        return out.reshape(cap, size, size, c), "pixel", k
    assert sx == 1 and sy == w and sc == h * w                   # plane-major
    vec = feat_addr % 16 == 0 and sy % k16 == 0 and sc % k16 == 0 and sn % k16 == 0
    grouped = c % k16 == 0 and out_addr % 16 == 0          # 16-byte vectors of channels
    k = k16 if vec else 1
    lp = ((k - 1 + size + k - 1) // k | 1) * k
    pc = c + k16 if grouped else 0                           # band tile elements per pixel
    rows = min(max((stage_bytes - 16) // ((2 * c * lp + size * pc) * esize), 1), size)
    div_c, div_s = _fast_div(c), _fast_div(size)
    n_bands = -(-size // rows)
    for p in range(cap):
        n = int(idx[0][p])
        x0 = int(idx[2][p]) * block - halo
        off = x0 % k
        xa = x0 - off
        nchunk = (off + size + k - 1) // k
        assert nchunk * k <= lp
        for band0 in range(0, n_bands, bands_per_block):         # blockIdx.y
            for b in range(band0, min(band0 + bands_per_block, n_bands)):
                r0 = b * rows
                nr = min(rows, size - r0)
                stage = np.zeros((nr, c, lp), mem.dtype)
                staged = np.zeros(stage.shape, bool)
                for r in range(nr):
                    y = int(idx[1][p]) * block - halo + r0 + r
                    for ch in range(c):
                        for q in range(nchunk):
                            x = xa + q * k
                            staged[r, ch, q * k:q * k + k] = True
                            if 0 <= n < n_maps and 0 <= y < h and 0 <= x and x + k <= w:
                                src = n * sn + ch * sc + y * sy + x
                                assert (feat_addr + src * esize) % (k * esize) == 0
                                stage[r, ch, q * k:q * k + k] = mem[src:src + k]
                assert staged[:, :, off:off + size].all()
                tile = stage[:, :, off:off + size].transpose(0, 2, 1).reshape(-1)
                dst = (p * size + r0) * size * c
                length = nr * size * c
                if grouped:                                      # whole vectors per pixel
                    for i in range(0, length, k16):
                        assert (out_addr + (dst + i) * esize) % 16 == 0
                        out[dst + i:dst + i + k16] = tile[i:i + k16]
                        written[dst + i:dst + i + k16] += 1
                    continue
                # straight from the stage: element e is (row, pixel, channel)
                # by two fast divisions, then a walk over the vector
                sh = (out_addr + dst * esize) % 16 // esize
                head = min((k16 - sh) % k16, length)
                nvec = (length - head) // k16
                assert (out_addr + (dst + head) * esize) % 16 == 0 or nvec == 0
                spans = ([(i, 1) for i in range(head)]
                         + [(head + v * k16, k16) for v in range(nvec)]
                         + [(i, 1) for i in range(head + nvec * k16, length)])
                for e0, m in spans:
                    q = _fast_quotient(e0, div_c)
                    r = _fast_quotient(q, div_s)
                    x, ch = q - r * size, e0 - q * c
                    for i in range(m):
                        out[dst + e0 + i] = stage[r, ch, off + x]
                        ch += 1
                        if ch == c:
                            ch, x = 0, x + 1
                            if x == size:
                                x, r = 0, r + 1
                    written[dst + e0:dst + e0 + m] += 1
                np.testing.assert_array_equal(out[dst:dst + length], tile)
    assert (written == 1).all()
    return out.reshape(cap, size, size, c), "plane" + "_grouped" * grouped, k


# (C, block, halo, H, W, dtype, layout, feat_addr, out_addr): ragged shapes --
# halo > block, map widths whose rows leave 8-byte (W=50 f32) and 4-byte (W=49
# f32, W=50 bf16) misalignment, and start addresses off 16 bytes -- beside
# aligned shapes that take the 16-byte instances of both layouts
@pytest.mark.parametrize("c,block,halo,h,w,dtype,layout,feat_addr,out_addr", [
    (1, 16, 8, 48, 96, torch.float32, "pixel", 0, 0),
    (1, 8, 11, 40, 56, torch.bfloat16, "plane", 0, 0),
    (3, 8, 10, 40, 56, torch.float32, "pixel", 0, 0),
    (3, 8, 10, 40, 56, torch.float32, "plane", 0, 0),
    (6, 16, 5, 48, 50, torch.float32, "plane", 0, 0),
    (6, 16, 5, 48, 49, torch.float32, "plane", 0, 0),
    (6, 16, 5, 48, 64, torch.bfloat16, "plane", 0, 0),
    (6, 16, 5, 48, 50, torch.bfloat16, "plane", 0, 0),
    (6, 16, 5, 48, 64, torch.float32, "pixel", 0, 0),
    (32, 8, 2, 32, 48, torch.float32, "pixel", 8, 0),
    (32, 8, 2, 32, 48, torch.bfloat16, "pixel", 0, 0),
    (32, 8, 2, 32, 48, torch.bfloat16, "plane", 0, 0),
    (64, 4, 3, 16, 24, torch.float32, "pixel", 0, 0),
    (64, 4, 3, 16, 24, torch.float32, "plane", 4, 0),
    (64, 4, 3, 16, 24, torch.float32, "plane", 0, 8),
    (64, 4, 9, 16, 24, torch.bfloat16, "plane", 0, 0),
])
def test_gather_kernel_plan_matches_plain(c, block, halo, h, w, dtype, layout, feat_addr,
                                          out_addr):
    """The CUDA gather's work plan gives the twin's windows bit for bit."""
    rs = np.random.RandomState(c * 7 + halo)
    n = 2
    idx = _indices(rs, n, h // block, w // block, 7)
    idx[0][-1] = n                                               # an n outside [0, N)
    x = torch.from_numpy(rs.randn(n, h, w, c).astype(np.float32)).to(dtype)
    if layout == "plane":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    mem = x.permute(0, 3, 1, 2).contiguous() if layout == "plane" else x
    mem = mem.view(bits).reshape(-1).numpy()
    got, kind, k = _gather_kernel_emulation(mem, x.shape, kg.feat_strides(x), idx, block, halo,
                                            x.element_size(), feat_addr, out_addr)
    assert kind.split("_")[0] == ("pixel" if c == 1 else layout)
    ref = kg.gather_patches_plain(x, *(torch.from_numpy(a[:-1]) for a in idx), block, halo)
    np.testing.assert_array_equal(got[:-1], ref.view(bits).numpy())
    assert not got[-1].any()                                     # zeros for that n
    if feat_addr or w in (49, 50) or (layout == "pixel" and (out_addr or c == 3)):
        assert k == 1                                            # the one-element instance


def test_gather_kernel_plan_takes_16_byte_vectors_on_the_main_path():
    """At the main-path geometries both layouts get the 16-byte instance."""
    k16 = {torch.float32: 4, torch.bfloat16: 8}
    for c, block, halo, layout, dtype in [(1, 64, 32, "pixel", torch.float32),
                                          (64, 8, 3, "pixel", torch.float32),
                                          (64, 8, 3, "pixel", torch.bfloat16),
                                          (64, 16, 4, "plane", torch.bfloat16),
                                          (32, 32, 2, "plane", torch.float32),
                                          (6, 64, 5, "plane", torch.bfloat16)]:
        h, w = 2 * block, 3 * block
        x = torch.zeros(1, c, h, w, dtype=dtype).permute(0, 2, 3, 1)
        if layout == "pixel":
            x = x.contiguous()
        idx = [np.array(a, np.int64) for a in ([0, 0], [0, 1], [2, 0])]
        mem = np.zeros(x.numel(), np.int16 if dtype == torch.bfloat16 else np.int32)
        _, kind, k = _gather_kernel_emulation(mem, x.shape, kg.feat_strides(x), idx, block,
                                              halo, x.element_size())
        assert (kind, k) == (layout + "_grouped" * (layout == "plane" and c % k16[dtype] == 0),
                             k16[dtype]), (c, block, layout)


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


_UNKNOWN_CU = (Path(ku.__file__).parent / "csrc" / "compute_unknown.cu").read_text()


def _unknown_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _UNKNOWN_CU).group(1))


def test_kernel_plan_constants_match_the_source():
    """The host plan in unknown.py and the kernel agree on strip, chunk and band."""
    assert ku.STRIP_COLS == 32 * _unknown_const("kStripWords")
    assert ku.CHUNK_ROWS == tuple(map(int, re.search(
        r"chunk_rows != (\d+) && chunk_rows != (\d+)", _UNKNOWN_CU).groups()))
    assert all(_unknown_const("kMaxStaged") % c == 0 for c in ku.CHUNK_ROWS)
    assert _unknown_const("kMaxStaged") >= ku.MAX_BAND_ROWS + 32
    assert ku.MAX_BAND_ROWS == _unknown_const("kMaxBandRows")
    assert 2 * _unknown_const("kMaxHalo") + 1 == ku.MAX_WIDTH


def _constexpr_element(width):
    """csrc/compute_unknown.cu's make_element in Python: cv2's ellipse rows by
    integer arithmetic (dx is the integer nearest sqrt(r^2 - dy^2)), sorted by
    (extent width, dy)."""
    if width <= 1:
        return [(0, 0, 0)]
    r, runs = width // 2, []
    for dy in range(-r, width - r):
        n = r * r - dy * dy
        k = int(np.sqrt(n))
        k = k + 1 if (k + 1) ** 2 <= n else k
        dx = k + 1 if n - k * k > k else k
        runs.append((dy, max(r - dx, 0) - r, min(r + dx + 1, width) - 1 - r))
    return sorted(runs, key=lambda t: (t[2] - t[1], t[0]))


def test_kernel_element_matches_cv2():
    """The element the kernel computes at compile time is the port's cv2
    replica, run for run and in the same order, for every width it takes."""
    for width in range(0, 34):
        assert _constexpr_element(width) == ku._sorted_runs(width), width
        extents, runs, ry = ku.run_table(2 * width)
        assert [(dy, *extents[e]) for dy, e in runs] == _constexpr_element(width)


def _shift_words(vp, vc, vn, dx):
    """The kernel's funnel shift: bit i of the result is column i + dx of the
    stream (vp, vc, vn) of three 32-bit words, vc in the middle."""
    vp, vc, vn = (v.astype(np.uint64) for v in (vp, vc, vn))
    if dx >= 0:
        return (((vn << np.uint64(32)) | vc) >> np.uint64(dx)) & np.uint64(0xFFFFFFFF)
    return ((((vc << np.uint64(32)) | vp) << np.uint64(-dx)) >> np.uint64(32)) \
        & np.uint64(0xFFFFFFFF)


def _unknown_kernel_emulation(mem, offset, m, h, w, k_size, sms):
    """numpy emulation of csrc/compute_unknown.cu's work plan on the maps
    (m, h, w) stored in ``mem`` from element ``offset``: the host's plan and
    choice of instance (ku.plan), the blocks' strips and bands, each band's
    chunks of staged rows (the host's height) copied as 16-byte lanes (guards:
    only the 16 columns next to the strip) into a ring of staging buffers ahead of use, and
    thresholded into words of 32 columns (the warps' ballots); pass A's
    horizontal ORs (funnel shifts widened over the nested extents, left and
    right of the word apart) by staged row; pass B's OR over the runs for the
    rows each chunk completes, stored as nibbles of four floats. It asserts
    that every 16-byte access is aligned, that each chunk is staged before it
    is read, that pass B reads only rows pass A wrote and that every output
    element is written once."""
    strip_words = ku.STRIP_COLS // 32
    row_words = strip_words + 2
    p = ku.plan(m, h, w, k_size, sms, in_addr=4 * offset)
    chunk, n_stages = p.chunk_rows, _unknown_const("kStages")
    threads = 8 * chunk                                          # a warp per 4 chunk rows
    unit_rows = 32 // strip_words                                # rows of a warp in A and B
    max_staged = _unknown_const("kMaxStaged")
    assert threads // 32 == 2 * chunk // unit_rows               # a warp pair per 8 rows
    stage_lanes = strip_words * 8 + 8                            # strip + 16 columns a side
    lo, hi = np.float32(ku._LO), np.float32(ku._HI)
    out = np.zeros(m * h * w, np.float32)
    written = np.zeros(out.shape, np.int64)
    item = np.arange(chunk * stage_lanes)                        # one chunk's copies
    lane = item % stage_lanes
    f = 32 * np.arange(row_words)[:, None] - 16 + np.arange(32)  # stage float of word j, bit i
    f_ok = (f >= 0) & (f < 4 * stage_lanes)
    for z in range(m):
        for band in range(p.n_bands):                            # blockIdx.x
            y0 = band * p.band_rows
            rows = min(p.band_rows, h - y0)
            staged = rows + 2 * p.ry
            n_chunks = -(-staged // chunk)
            for strip in range(p.n_strips):                      # blockIdx.y
                x0 = strip * ku.STRIP_COLS
                stages = np.zeros((n_stages, chunk, 4 * stage_lanes), np.float32)
                stage_of = np.full(n_stages, -1)                 # chunk held by each stage

                def issue(c):                                    # cp.async of chunk c
                    if c >= n_chunks:
                        return
                    s = c * chunk + item // stage_lanes
                    y, x = y0 - p.ry + s, x0 - 16 + lane * 4
                    ok = (s < staged) & (y >= 0) & (y < h)
                    src = offset + z * h * w + y * w + x
                    vals = np.zeros((item.size, 4), np.float32)
                    if p.vec:
                        ok &= (x >= 0) & (x < w)
                        assert (src[ok] * 4 % 16 == 0).all() and (x[ok] + 3 < w).all()
                        vals[ok] = mem[src[ok][:, None] + np.arange(4)]
                    else:
                        for k in range(4):
                            kok = ok & (x + k >= 0) & (x + k < w)
                            vals[kok, k] = mem[src[kok] + k]
                    stages[c % n_stages] = vals.reshape(chunk, -1)
                    stage_of[c % n_stages] = c

                assert staged <= max_staged
                ors = np.zeros((len(p.extents), max_staged, strip_words), np.uint32)
                has = np.zeros((len(p.extents), max_staged), bool)  # rows pass A wrote
                for c in range(n_stages - 1):
                    issue(c)
                done = 0
                for c in range(n_chunks):
                    issue(c + n_stages - 1)
                    assert stage_of[c % n_stages] == c
                    # each row's words by ballot: bit i of word j is stage float
                    # 32 j - 16 + i (zero beyond the staged guard columns)
                    v = np.where(f_ok, stages[c % n_stages][:, np.clip(f, 0, None)
                                                          .clip(None, 4 * stage_lanes - 1)], 0)
                    unc = ((v > lo) & (v < hi)).astype(np.uint64)
                    bits = (unc << np.arange(32, dtype=np.uint64)).sum(axis=2).astype(np.uint32)
                    # pass A: per staged word, the left lane ORs dx in [a, -1]
                    # and the right lane dx in [0, b], widened over the extents
                    rows_c = c * chunk + np.arange(chunk)
                    vp, vc, vn = bits[:, :-2], bits[:, 1:-1], bits[:, 2:]
                    left = np.zeros(vc.shape, np.uint64)
                    right = np.zeros(vc.shape, np.uint64)
                    reach_l, reach_r = 0, -1
                    for e, (a, b) in enumerate(p.extents):
                        assert -a >= reach_l and b >= reach_r
                        for j in range(reach_l + 1, -a + 1):
                            left |= _shift_words(vp, vc, vn, -j)
                        for d in range(reach_r + 1, b + 1):
                            right |= _shift_words(vp, vc, vn, d)
                        reach_l, reach_r = -a, b
                        # warp pairs whose rows all lie past the band skip it
                        live = rows_c // unit_rows * unit_rows < staged
                        ors[e, rows_c[live]] = (left | right)[live]
                        has[e, rows_c[live]] = True
                    ready = min(rows, (c + 1) * chunk - 2 * p.ry)
                    n_new = ready - done
                    if n_new <= 0:
                        continue
                    r = done + np.arange(n_new)[:, None]
                    wv = np.arange(strip_words)[None, :]
                    acc = np.zeros((n_new, strip_words), np.uint32)
                    for dy, e in p.runs:                         # pass B
                        srow = r + p.ry + dy
                        assert has[e, srow].all()
                        acc |= ors[e, srow, wv]
                    assert -(-n_new // unit_rows) <= threads // 32  # warps that store
                    i = np.arange(n_new * strip_words * 8)
                    rr, qo = i // (strip_words * 8), i % (strip_words * 8)
                    xo = x0 + qo * 4
                    nibo = acc[rr, qo // 8] >> (4 * (qo % 8)).astype(np.uint64)
                    dst = z * h * w + (y0 + done + rr) * w + xo
                    if p.vec:
                        assert (dst[xo < w] * 4 % 16 == 0).all()
                    for k in range(4):
                        kok = xo + k < w
                        out[dst[kok] + k] = (nibo[kok] >> np.uint64(k)) & np.uint64(1)
                        written[dst[kok] + k] += 1
                    done = ready
                assert done == rows
    assert (written == 1).all()
    return out.reshape(m, h, w), p


# (k_size, maps, H, W, start offset in floats, SM count): the main path's
# widths and k=7, 2 and 67 (half width 16); band and strip seams inside the
# maps; W not a multiple of 4 or 32, W under 32, H under 2 ry + 1, a start
# 4 bytes off 16-byte alignment; bands at their floor and at their cap
@pytest.mark.parametrize("k_size,m,h,w,offset,sms", [
    (30, 2, 70, 300, 0, 4),
    (27, 1, 64, 256, 0, 8),
    (15, 3, 40, 130, 0, 16),
    (7, 2, 50, 96, 1, 3),
    (2, 1, 33, 140, 0, 4),
    (67, 1, 20, 29, 0, 2),
    (67, 1, 300, 200, 0, 4),
    (30, 3, 72, 256, 0, 132),
    (15, 1, 600, 64, 0, 1),
    (30, 1, 120, 256, 0, 2),
])
def test_kernel_plan_matches_plain(k_size, m, h, w, offset, sms):
    """The CUDA kernel's work plan gives the twin's map bit for bit."""
    rs = np.random.RandomState(k_size + w)
    alpha = _alpha(rs, (m, h, w), p=0.002 if k_size > 20 else 0.01)
    alpha[0, 0, :] = np.float32(1 / 255)                          # on the thresholds
    alpha[-1, :, -1] = np.float32(254 / 255)
    alpha[0, h // 2, w // 3] = 0.5
    mem = np.concatenate([rs.rand(offset).astype(np.float32), alpha.ravel()])
    got, p = _unknown_kernel_emulation(mem, offset, m, h, w, k_size, sms)
    ref = ku.compute_unknown_plain(torch.from_numpy(alpha), k_size).numpy()
    assert 0.0 < ref.mean() < 1.0
    np.testing.assert_array_equal(got, ref)
    assert p.vec == (offset == 0 and w % 4 == 0)                 # the host's instance
    assert p.n_bands * p.band_rows >= h > (p.n_bands - 1) * p.band_rows


def test_kernel_plan_at_the_main_path_and_its_limits():
    """At (1, 3, 576, 1024) on 132 SMs: the 16-byte instance and two blocks per
    SM. The extents nest for every width up to 33; a wider element is refused
    before any launch, naming the largest k_size."""
    p = ku.plan(3, 576, 1024, 30, 132)
    assert p.vec and (p.band_rows, p.n_bands, p.n_strips) == (53, 11, 8)
    assert [ku.plan(3, 576, 1024, k, 132).chunk_rows for k in (30, 27, 15)] == [40, 40, 32]
    assert p.n_bands * p.n_strips * 3 == 2 * 132
    assert not ku.plan(3, 576, 1024, 30, 132, in_addr=4).vec
    for width in range(1, 34):
        runs = ku._sorted_runs(width)
        assert len(runs) == max(int(ellipse_kernel(width).any(axis=1).sum()), 1)
        extents, table, ry = ku.run_table(2 * width)
        assert ry <= 16 and all(-16 <= a <= b <= 16 for a, b in extents)
        for (a0, b0), (a1, b1) in zip(extents, extents[1:]):
            assert a1 <= a0 and b1 >= b0                         # nested
        assert sorted((dy, *extents[e]) for dy, e in table) == sorted(runs)
    assert _ellipse_row_runs(15)[0] == (-7, 0, 0)
    for k_size in (68, 69, 100):
        with pytest.raises(ValueError, match="k_size up to 67"):
            ku.plan(1, 8, 8, k_size, 132)
    ku.plan(1, 8, 8, 67, 132)


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
