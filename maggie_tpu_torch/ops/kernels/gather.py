"""Haloed patch gather and its transpose: CUDA kernel wrappers, their plain
PyTorch twins, and the autograd Function that joins them.

Port of the TPU kernel ``maggie_tpu/ops/pallas/gather.py::gather_patches_pallas``
(kernel source ``csrc/gather_patches.cu``). Contract, as the JAX package's
``_gather_patches_xla``: ``feat`` (N, H, W, C) -> (cap, S, S, C) with
S = block + 2*halo; patch p covers rows and columns
[b*block - halo, b*block + block + halo) of map ``idx_n[p]``, zeros outside
the map.

The kernel reads ``feat`` in either of two memory layouts under the logical
(N, H, W, C) shape, and never copies it into another:

- pixel-major: contiguous NHWC (any C=1 map is both);
- plane-major: ``x.permute(0, 2, 3, 1)`` of a contiguous NCHW ``x``, the
  encoder's own layout.

Any other layout raises. The output is always contiguous (cap, S, S, C).

The backward (``csrc/gather_patches_bwd.cu``) is the exact transpose: every
entry's window is added back into ``dfeat``, duplicate and padding entries
included, in a fixed order (the kernel's header says which), and ``dfeat``
comes back in the layout the forward read. It replaces the JAX package's
custom VJP (``maggie_tpu/ops/blocksparse.py:80-176``), whose ``dup_bound``
the port does not need: an index pass lists every tile's entries, however
many. The pull then runs one thread block per box of an output tile, stages
the windows that cover the box with 16-byte ``cp.async`` copies and sums them
in f32 registers, and writes plane-major ``dfeat`` through a turn in shared
memory. The pull's shared memory is fixed (a 64 KB ring), so the wrapper
checks only the index pass's against the card's limit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# Incremented once per kernel launch (never by the plain twin), so a run can
# show that its path went through the kernel.
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the C entry point, set up at first launch


def _entry():
    global _fn
    if _fn is None:
        from .build import load
        fn = load("gather_patches").gather_patches_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 4
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def gather_patches_plain(feat: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                         idx_bx: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """Plain PyTorch twin: zero-pad the map by ``halo``, then one advanced-index
    read of every window."""
    size = block + 2 * halo
    padded = F.pad(feat, (0, 0, halo, halo, halo, halo))
    ar = torch.arange(size, device=feat.device)
    ys = (idx_by * block)[:, None] + ar            # (cap, S)
    xs = (idx_bx * block)[:, None] + ar
    return padded[idx_n[:, None, None], ys[:, :, None], xs[:, None, :]]


def feat_strides(feat: torch.Tensor) -> tuple[int, int, int, int]:
    """(n, y, x, c) element strides of a pixel- or plane-major (N, H, W, C) map,
    as the kernel addresses it; ValueError for any other layout."""
    n, h, w, c = feat.shape
    if feat.is_contiguous():
        return h * w * c, w * c, c, 1
    if feat.permute(0, 3, 1, 2).is_contiguous():
        return c * h * w, w, 1, h * w
    raise ValueError(f"gather_patches kernel reads contiguous NHWC or the NHWC view of a "
                     f"contiguous NCHW map, got shape {tuple(feat.shape)} strides "
                     f"{feat.stride()}")


def _launch(feat, idx_n, idx_by, idx_bx, block, halo):
    global launches
    if feat.dtype not in _DTYPES:
        raise TypeError(f"gather_patches kernel takes float32 or bfloat16, not {feat.dtype}")
    if feat.dim() != 4:
        raise ValueError(f"gather_patches kernel needs an (N, H, W, C) map, got "
                         f"shape {tuple(feat.shape)}")
    strides = feat_strides(feat)
    for name, t in (("idx_n", idx_n), ("idx_by", idx_by), ("idx_bx", idx_bx)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != feat.device or t.shape[0] != idx_n.shape[0]:
            raise ValueError(f"{name} must be a contiguous int64 vector of length cap "
                             f"on {feat.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    n, h, w, c = feat.shape
    size = block + 2 * halo
    cap = idx_n.shape[0]
    out = torch.empty((cap, size, size, c), dtype=feat.dtype, device=feat.device)
    fn = _entry()
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    rc = fn(feat.data_ptr(), idx_n.data_ptr(), idx_by.data_ptr(), idx_bx.data_ptr(),
            out.data_ptr(), _DTYPES[feat.dtype], cap, n, h, w, c, block, halo, *strides,
            stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: cudaError {rc}")
    launches += 1
    return out


def _forward(feat, idx_n, idx_by, idx_bx, block, halo):
    """The CUDA kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if feat.device.type == "cpu":
        return gather_patches_plain(feat, idx_n, idx_by, idx_bx, block, halo)
    if feat.device.type != "cuda":
        raise ValueError(f"gather_patches runs on cuda or cpu, not {feat.device}")
    with torch.cuda.device(feat.device):  # the launch goes to the current device
        return _launch(feat, idx_n, idx_by, idx_bx, block, halo)


# ------------------------------------------------------------------ backward

# Incremented once per backward kernel launch (never by the plain twin).
bwd_launches = 0
_bwd_fn = None  # the C entry point, set up at first launch
_bwd_index_fn = None  # the index pass's own entry point (timing only)
INDEX_THREADS = 1024          # csrc/gather_patches_bwd.cu kIndexThreads
MAX_SMEM_BYTES = 232448       # shared memory one thread block may use on the H100


def _tile_grid(shape, block: int) -> tuple[int, int, int]:
    n, h, w, _ = shape
    nby, nbx = -(-h // block), -(-w // block)
    return nby, nbx, n * nby * nbx


def gather_patches_bwd_plain(g: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                             idx_bx: torch.Tensor, shape: tuple, block: int, halo: int,
                             plane: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel, summing in its order.

    Each entry gets a slot (tile, rank) from a stable sort of its tile key, so
    a tile's entries have ranks in ascending p. Then for each neighbour offset
    (dy, dx) in row-major order and each rank, one indexed read of the
    zero-padded slot table gives every output element the value of the entry
    at that slot (0 where the slot is empty or its window misses the element),
    added to an f32 accumulator; the result is rounded once. The adds of 0
    leave the sum unchanged, so it equals the kernel's bit for bit, in f32 and
    in bf16. ``plane`` returns the NHWC view of NCHW memory, as the kernel."""
    n, h, w, c = shape
    cap, size = g.shape[0], g.shape[1]
    nby, nbx, n_tiles = _tile_grid(shape, block)
    dev = g.device
    ok = ((idx_n >= 0) & (idx_n < n) & (idx_by >= 0) & (idx_by < nby)
          & (idx_bx >= 0) & (idx_bx < nbx))
    key = torch.where(ok, (idx_n * nby + idx_by) * nbx + idx_bx, n_tiles)
    sorted_key, order = torch.sort(key, stable=True)
    rank = torch.arange(cap, device=dev) - torch.searchsorted(sorted_key, sorted_key)
    ranks = int(rank.max()) + 1 if cap else 1
    slot = torch.full((n_tiles + 1, ranks), cap, dtype=torch.int64, device=dev)
    slot[sorted_key, rank] = order                 # row n_tiles: entries off the grid
    gz = torch.cat([g, g.new_zeros((1, size, size, c))])
    reach = -(-halo // block)
    acc_dtype = torch.promote_types(g.dtype, torch.float32)   # f32 for f32 and bf16
    acc = torch.zeros((n, h, w, c), dtype=acc_dtype, device=dev)
    ns = torch.arange(n, device=dev)[:, None, None]

    def axis(length, nb, d):
        pos = torch.arange(length, device=dev)
        t = pos // block + d
        r = pos - t * block + halo
        return t.clamp(0, nb - 1), r.clamp(0, size - 1), (t >= 0) & (t < nb) & (r >= 0) & (r < size)

    for dy in range(-reach, reach + 1):
        ty, ry, oky = axis(h, nby, dy)
        for dx in range(-reach, reach + 1):
            tx, rx, okx = axis(w, nbx, dx)
            tile = (ns * nby + ty[None, :, None]) * nbx + tx[None, None, :]
            inside = oky[None, :, None] & okx[None, None, :]
            for r in range(ranks):
                p = torch.where(inside, slot[tile, r], cap)
                acc = acc + gz[p, ry[None, :, None], rx[None, None, :]].to(acc_dtype)
    out = acc.to(g.dtype)
    return out.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if plane else out


def _bwd_entry():
    global _bwd_fn
    if _bwd_fn is None:
        from .build import load
        fn = load("gather_patches_bwd").gather_patches_bwd_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        _bwd_fn = fn
    return _bwd_fn


def _launch_bwd(g, idx_n, idx_by, idx_bx, shape, block, halo, plane):
    global bwd_launches
    if g.dtype not in _DTYPES:
        raise TypeError(f"gather_patches backward kernel takes float32 or bfloat16, not {g.dtype}")
    n, h, w, c = shape
    cap, size = idx_n.shape[0], block + 2 * halo
    if tuple(g.shape) != (cap, size, size, c) or not g.is_contiguous():
        raise ValueError(f"gather_patches backward kernel needs a contiguous "
                         f"{(cap, size, size, c)} gradient, got {tuple(g.shape)} "
                         f"strides {g.stride()}")
    for name, t in (("idx_n", idx_n), ("idx_by", idx_by), ("idx_bx", idx_bx)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != g.device or t.shape[0] != cap:
            raise ValueError(f"{name} must be a contiguous int64 vector of length cap "
                             f"on {g.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    _, _, n_tiles = _tile_grid(shape, block)
    smem = (cap + n_tiles + 1 + INDEX_THREADS) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"gather_patches backward kernel lists at most "
                         f"{MAX_SMEM_BYTES // 4 - INDEX_THREADS - 1} entries and tiles in "
                         f"all, got {cap} entries over {n_tiles} tiles")
    if plane:
        dfeat = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device).permute(0, 2, 3, 1)
    else:
        dfeat = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    scratch = torch.empty(n_tiles + 1 + cap, dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _bwd_entry()(g.data_ptr(), idx_n.data_ptr(), idx_by.data_ptr(), idx_bx.data_ptr(),
                      dfeat.data_ptr(), scratch.data_ptr(), _DTYPES[g.dtype], cap, n, h, w, c,
                      block, halo, int(plane), stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches backward kernel launch failed: cudaError {rc}")
    bwd_launches += 1
    return dfeat


def bwd_index_pass(idx_n: torch.Tensor, idx_by: torch.Tensor, idx_bx: torch.Tensor,
                   shape: tuple, block: int) -> torch.Tensor:
    """The backward kernel's index pass alone, on the inputs ``_launch_bwd``
    checks; returns its scratch (tile starts, then the lists). For timing the
    pass apart from the pull: it is not a launch of the backward and is not
    counted in ``bwd_launches``."""
    global _bwd_index_fn
    if _bwd_index_fn is None:
        from .build import load
        fn = load("gather_patches_bwd").gather_patches_bwd_index_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        _bwd_index_fn = fn
    n, h, w, _ = shape
    scratch = torch.empty(_tile_grid(shape, block)[2] + 1 + idx_n.shape[0], dtype=torch.int32,
                          device=idx_n.device)
    stream = torch.cuda.current_stream(idx_n.device).cuda_stream
    rc = _bwd_index_fn(idx_n.data_ptr(), idx_by.data_ptr(), idx_bx.data_ptr(),
                       scratch.data_ptr(), idx_n.shape[0], n, h, w, block, stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches backward index pass launch failed: cudaError {rc}")
    return scratch


def gather_patches_bwd(g: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                       idx_bx: torch.Tensor, shape: tuple, block: int, halo: int,
                       plane: bool = False) -> torch.Tensor:
    """d feat of ``gather_patches`` for the output gradient ``g``: the CUDA
    kernel for a CUDA tensor, the plain twin for a CPU tensor. ``plane`` asks
    for the plane-major layout (the NHWC view of contiguous NCHW memory)."""
    if g.device.type == "cpu":
        return gather_patches_bwd_plain(g, idx_n, idx_by, idx_bx, shape, block, halo, plane)
    if g.device.type != "cuda":
        raise ValueError(f"gather_patches backward runs on cuda or cpu, not {g.device}")
    with torch.cuda.device(g.device):
        return _launch_bwd(g, idx_n, idx_by, idx_bx, tuple(shape), block, halo, plane)


def _plane_major(feat: torch.Tensor) -> bool:
    return not feat.is_contiguous() and feat.permute(0, 3, 1, 2).is_contiguous()


class _GatherPatches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, idx_n, idx_by, idx_bx, block, halo):
        ctx.save_for_backward(idx_n, idx_by, idx_bx)
        ctx.geometry = (tuple(feat.shape), block, halo, _plane_major(feat))
        return _forward(feat, idx_n, idx_by, idx_bx, block, halo)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        shape, block, halo, plane = ctx.geometry
        dfeat = gather_patches_bwd(g.contiguous(), *ctx.saved_tensors, shape, block, halo, plane)
        return dfeat, None, None, None, None, None


def gather_patches(feat: torch.Tensor, idx_n: torch.Tensor, idx_by: torch.Tensor,
                   idx_bx: torch.Tensor, block: int, halo: int) -> torch.Tensor:
    """The haloed patch gather, differentiable in ``feat``: the CUDA kernels
    (forward and backward) for a CUDA tensor, their plain twins for a CPU
    tensor. No backward runs for a ``feat`` that does not require grad."""
    return _GatherPatches.apply(feat, idx_n, idx_by, idx_bx, block, halo)
