"""Fixed-capacity block-sparse machinery for the detail-refinement ladder.

Port of ``maggie_tpu/ops/blocksparse.py`` (eval forward):

1. ``select_blocks`` tiles the active mask into blocks, scores each block by its
   active-pixel count and keeps a fixed capacity of (sample, by, bx) entries;
2. ``gather_patches`` (CUDA kernel on the card, ``ops/kernels/gather.py``)
   reads haloed windows around the selected blocks;
3. ``scatter_blocks`` writes the exact core regions back into a dense buffer.
"""

from __future__ import annotations

import torch

from .kernels.gather import gather_patches, gather_patches_plain

__all__ = ["select_blocks", "gather_patches", "gather_patches_plain", "scatter_blocks"]


def select_blocks(mask: torch.Tensor, block: int, cap: int):
    """mask: (N, H, W) 0/1. Returns (idx_n, idx_by, idx_bx, valid), each (cap,).

    Blocks are (block x block) tiles scored by active count; the top ``cap`` are
    kept and ``valid`` marks entries with a positive score.

    Tie order: ``lax.top_k`` (``maggie_tpu/ops/blocksparse.py:56``) returns equal
    scores in ascending index order, and block scores are integer counts that
    tie massively (every fully uncertain block scores block**2). ``torch.topk``
    promises no order among ties, so this sorts stably in descending order and
    takes the first ``k``: the same blocks as the JAX package, in the same order.
    """
    n, h, w = mask.shape
    nby, nbx = h // block, w // block
    scores = mask[:, :nby * block, :nbx * block].reshape(n, nby, block, nbx, block).sum((2, 4))
    flat = scores.reshape(-1)
    k = min(cap, flat.shape[0])
    top_scores, top_idx = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    if k < cap:  # pad up to the fixed capacity
        top_scores = torch.cat([top_scores, top_scores.new_zeros(cap - k)])
        top_idx = torch.cat([top_idx, top_idx.new_zeros(cap - k)])
    valid = top_scores > 0
    idx_n = top_idx // (nby * nbx)
    rem = top_idx % (nby * nbx)
    return idx_n, rem // nbx, rem % nbx, valid


def scatter_blocks(cores: torch.Tensor, idx_n, idx_by, idx_bx, valid,
                   out_shape: tuple, fill: float = 0.0) -> torch.Tensor:
    """cores (cap, block, block, C) -> dense (N, H, W, C), ``fill`` at tiles that
    no valid entry covers. Invalid entries are dropped: they are written to a
    spill tile past the end of the tile grid, which is cut off."""
    n, h, w, c = out_shape
    cap, block = cores.shape[0], cores.shape[1]
    nby, nbx = h // block, w // block
    n_tiles = n * nby * nbx
    tile = idx_n * (nby * nbx) + idx_by * nbx + idx_bx
    tile = torch.where(valid, tile, torch.full_like(tile, n_tiles))
    tiles = cores.new_full((n_tiles + 1, block, block, c), fill)
    tiles[tile] = cores
    return (tiles[:n_tiles].reshape(n, nby, nbx, block, block, c)
            .permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c))
