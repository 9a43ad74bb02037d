"""Row sharding: each frame's rows split over the ranks of a ``space`` group,
beside the data ranks (the port's counterpart of ``create_mesh_2d`` and
``shard_batch_2d`` in ``maggie_tpu/parallel/mesh.py``).

The world is ``data x space``: global rank ``d * space + s`` holds band ``s``
(whole 64-row ladder blocks at os1) of the frames of data shard ``d``
(``shard_batch_2d``); a ``space`` group holds the bands of one shard
(``init_groups``). GSPMD inserts the exchanges itself; here the flagship
train step makes them by hand:

- banded stages (the encoder's stem, first stage and its first three
  shortcuts, the os8 alpha at os1, K2, the ladder's gathers, scatters and
  dense hand-offs, the fusion and the losses) run on the band. A dense conv
  takes its padding's rows from the neighbour bands (``halo_rows``: zeros at
  the frame's own top and bottom, where the conv pads with zeros); a local
  op with another edge rule takes its reach's rows and crops (``rows_op``,
  ``pad``); a resize takes the band's rows of the whole frame's
  weight matrix (``resize_rows``);
- replicated stages (``parallel.replicated()``: the encoder from its second
  stage down, ASPP, os32 -> os8 and the attention) run on the whole frame
  of the shard on every space rank, from ``gather_rows`` of the os4 map.
  Their batch statistics sum every rank's copy at the world's count (equal
  on every rank however the card's convs round the copies), their draws go
  by data rank, and a loss term computed there enters the total once
  (space rank 0).

``gather_rows``' backward is a reduce-scatter (a sum over the space group,
then the rank's band): every space rank's losses reach the replicated copy
it holds. ``halo_rows``' backward sends each halo's gradient to the rank
that owns the rows. Both exchange through ``all_gather``/``all_reduce``,
which gloo also takes on CUDA tensors (no point-to-point). Everything here
is the identity at ``space`` 1, the data-parallel code path bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import dist as pdist
from ..ops.resize import resize_bilinear

BLOCK = 64   # os1 rows of one ladder block: a band is a whole number of them


def init_groups(space: int) -> None:
    """Split the world (joined by ``init_from_env``) into ``data x space``
    ranks: every rank creates every space group, in one order. ``space`` 1
    leaves row sharding."""
    world = pdist.world()
    if space < 1 or world % space:
        raise ValueError(f"space {space} does not divide the world of {world} ranks")
    if space == 1:
        pdist.set_groups(1, None)
        return
    space_group = None
    for d in range(world // space):
        g = dist.new_group(list(range(d * space, (d + 1) * space)), timeout=pdist.TIMEOUT)
        if pdist.rank() // space == d:
            space_group = g
    pdist.set_groups(space, space_group)


def world() -> int:
    return pdist.space_world()


def rank() -> int:
    return pdist.space_rank()


def banded() -> bool:
    """True where the step's dense maps are bands: row sharding outside a
    replicated stage."""
    return pdist.space_world() > 1 and not pdist.in_replicated()


def check_rows(h: int, space: int, what: str = "frame") -> None:
    """ValueError unless ``h`` rows split into ``space`` bands of whole
    64-row blocks."""
    if h % (space * BLOCK):
        raise ValueError(f"a {what} of {h} rows does not split into {space} bands of whole "
                         f"{BLOCK}-row blocks (rows must be a multiple of {space * BLOCK})")


def shard_batch_2d(batch: dict, rank: int, world: int, space: int) -> dict:
    """Rank ``rank``'s part of ``batch``: its data shard's contiguous rows of
    the batch (``dist.shard_rows`` over ``world / space`` shards), then band
    ``rank % space`` of each frame's rows: dim 2 of ``image`` (b, n_f, H, W,
    3), dim 3 of ``mask`` (b, n_f, n_i, H/8, W/8), ``alpha`` and
    ``transition`` (b, n_f, n_i, H, W), as ``mesh.py:38-53`` places them."""
    rows = pdist.shard_rows(batch, rank // space, world // space)
    h = batch["image"].shape[2]
    check_rows(h, space)
    s, out = rank % space, {}
    for k, v in rows.items():
        dim = 2 if k == "image" else 3
        want = h // 8 if k == "mask" else h
        if v.shape[dim] != want:
            raise ValueError(f"{k}: {v.shape[dim]} rows where the frame of {h} rows has {want}")
        n = want // space
        out[k] = v.narrow(dim, s * n, n)
    return out


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t, group=pdist.space_group())
    return parts


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, dim):
        h = x.shape[dim]
        if above > h or below > h:
            raise ValueError(f"a halo of {max(above, below)} rows exceeds the band's {h}")
        ctx.geometry = (above, below, dim)
        s, n = rank(), world()
        parts = _all_gather(torch.cat([x.narrow(dim, 0, below), x.narrow(dim, h - above, above)],
                                      dim))
        zeros = lambda k: x.new_zeros(x.shape[:dim] + (k,) + x.shape[dim + 1:])
        top = parts[s - 1].narrow(dim, below, above) if s > 0 else zeros(above)
        bottom = parts[s + 1].narrow(dim, 0, below) if s < n - 1 else zeros(below)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        above, below, dim = ctx.geometry
        s, n = rank(), world()
        h = g.shape[dim] - above - below
        parts = _all_gather(torch.cat([g.narrow(dim, 0, above),
                                       g.narrow(dim, above + h, below)], dim))
        dx = g.narrow(dim, above, h).contiguous()
        if s < n - 1:       # the rank below read this band's last rows as its top halo
            dx.narrow(dim, h - above, above).add_(parts[s + 1].narrow(dim, 0, above))
        if s > 0:           # the rank above read the first rows as its bottom halo
            dx.narrow(dim, 0, below).add_(parts[s - 1].narrow(dim, above, below))
        return dx, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, dim: int = -2) -> torch.Tensor:
    """The band ``x`` with ``above`` rows of the band above it and ``below``
    rows of the band below it along ``dim``, zeros beyond the frame's top
    and bottom. Differentiable: each halo's gradient is added to the rows of
    the rank that owns them."""
    if world() == 1:
        return _edge_pad(x, above, below, "constant", dim % x.dim())
    return _HaloRows.apply(x, above, below, dim % x.dim())


def pad_rows(x: torch.Tensor, rows: int, mode: str, dim: int = -2) -> torch.Tensor:
    """``rows`` rows on each side of the band ``x``: the neighbours' at a band
    edge, and at the frame's own edge what ``F.pad``'s ``mode`` gives
    ("constant" zeros, "reflect", "replicate"), differentiable."""
    dim = dim % x.dim()
    y = halo_rows(x, rows, rows, dim)
    if mode == "constant":
        return y
    h = x.shape[dim]
    top, mid, bottom = y.narrow(dim, 0, rows), x, y.narrow(dim, rows + h, rows)
    if rank() == 0:
        top = _edge_pad(x, rows, 0, mode, dim).narrow(dim, 0, rows)
    if rank() == world() - 1:
        bottom = _edge_pad(x, 0, rows, mode, dim).narrow(dim, h, rows)
    return torch.cat([top, mid, bottom], dim)


def pad(x: torch.Tensor, padding: tuple[int, int, int, int], mode: str) -> torch.Tensor:
    """``F.pad(x, padding, mode)`` of the last two dims where the step is not
    banded. On a band the row padding (top and bottom equal) is the
    neighbours' rows at a band edge (``pad_rows``)."""
    if not banded():
        return F.pad(x, padding, mode=mode)
    left, right, top, bottom = padding
    if top != bottom:
        raise ValueError(f"a band pads its rows alike above and below, not {top} and {bottom}")
    return F.pad(pad_rows(x, top, mode), (left, right, 0, 0), mode=mode)


def _edge_pad(x, above: int, below: int, mode: str, dim: int) -> torch.Tensor:
    if mode == "constant":
        return torch.cat([x.new_zeros(x.shape[:dim] + (above,) + x.shape[dim + 1:]), x,
                          x.new_zeros(x.shape[:dim] + (below,) + x.shape[dim + 1:])], dim)
    if mode == "reflect":
        h = x.shape[dim]
        return torch.cat([x.narrow(dim, 1, above).flip(dim), x,
                          x.narrow(dim, h - 1 - below, below).flip(dim)], dim)
    if mode == "replicate":
        h = x.shape[dim]
        first, last = x.narrow(dim, 0, 1), x.narrow(dim, h - 1, 1)
        return torch.cat([first.expand(first.shape[:dim] + (above,) + first.shape[dim + 1:]), x,
                          last.expand(last.shape[:dim] + (below,) + last.shape[dim + 1:])], dim)
    raise ValueError(f"pad_rows: unknown mode {mode!r}")


def rows_op(x: torch.Tensor, reach: int, fn, dim: int = -2) -> torch.Tensor:
    """``fn`` of a local op whose output rows read at most ``reach`` rows
    either side, on the band ``x``: ``fn`` of the band plus ``reach`` rows of
    the neighbours (none beyond the frame, where ``fn`` keeps its own edge
    rule), cropped to the band. The halo'd band is contiguous."""
    if world() == 1:
        return fn(x)
    dim = dim % x.dim()
    above = reach if rank() > 0 else 0
    below = reach if rank() < world() - 1 else 0
    y = halo_rows(x, reach, reach, dim)
    y = y.narrow(dim, reach - above, above + x.shape[dim] + below).contiguous()
    return fn(y).narrow(dim, above, x.shape[dim])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return torch.cat(_all_gather(x), dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=pdist.space_group())
        h = g.shape[ctx.dim] // world()
        return g.narrow(ctx.dim, rank() * h, h), None


def gather_rows(x: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """The whole frame from every space rank's band along ``dim``. Its
    backward is a reduce-scatter: the gradient summed over the space group
    (each rank's losses reached its own replicated copy), then this rank's
    band."""
    if world() == 1:
        return x
    return _GatherRows.apply(x, dim % x.dim())


def conv_rows(x: torch.Tensor, padding):
    """A dense conv's input and padding on a band: ``x`` with the padding's
    rows of the neighbours (zeros beyond the frame) and no row padding, so
    that the conv gives the band's rows of the whole frame's output (a
    strided conv's band starts on its stride). Unchanged elsewhere."""
    if not banded():
        return x, padding
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    if ph == 0:
        return x, padding
    return halo_rows(x, ph, ph), (0, pw)


def band(rows: int) -> tuple[int, int]:
    """This rank's band [lo, hi) of a frame of ``rows`` rows."""
    n = rows // world()
    return rank() * n, (rank() + 1) * n


def resize_rows(x: torch.Tensor, size: tuple[int, int], align_corners: bool = False,
                halo: int | None = None) -> torch.Tensor:
    """``resize_bilinear(x, size)`` where the step is not banded. On a band,
    ``size`` the band's: this band's rows of the whole frame's resize, from
    ``x`` the whole map (a replicated stage's), or with ``halo`` from the
    input's band and ``halo`` rows of either neighbour (zeros beyond the
    frame, where the weights are 0)."""
    if not banded():
        return resize_bilinear(x, size, align_corners)
    h_out = size[0] * world()
    if halo is None:
        return resize_bilinear(x, (h_out, size[1]), align_corners, rows=band(h_out))
    h_in = x.shape[-2] * world()
    return resize_bilinear(halo_rows(x, halo, halo), (h_out, size[1]), align_corners,
                           rows=band(h_out), in_rows=(band(h_in)[0] - halo, h_in))


def frame_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last two dims of the whole frame (keepdim),
    detached: the band's sums added over the space group."""
    s = x.sum(dim=(-2, -1), keepdim=True)
    if world() == 1:
        return s
    s = s.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(s, group=pdist.space_group())
    return s


def frame_mask_pool(x: torch.Tensor, k: int, use_max: bool) -> torch.Tensor:
    """The whole frame of a k-pooled 0/1 map of the band ``x`` (..., h, w):
    max pool, or average pool then > 0 (window rows never cross a band)."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    y = x.reshape(-1, 1, h, w).float()
    y = F.max_pool2d(y, k) if use_max else (F.avg_pool2d(y, k) > 0.0).float()
    return gather_rows(y.reshape(lead + y.shape[-2:]).to(x.dtype))


def replicated_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term of a replicated stage, which every space rank computes
    alike: counted once in the total, on space rank 0 (the others' copy is
    weighted 0, so that no gradient reaches the total twice)."""
    if world() == 1 or rank() == 0:
        return x
    return x * 0.0
