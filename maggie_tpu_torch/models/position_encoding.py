"""Sine position embeddings (port of ``maggie_tpu/models/position_encoding.py``;
reference ``module/position_encoding.py``)."""

from __future__ import annotations

import torch


def temporal_position_embedding_sine(b: int, n_f: int, h: int, w: int, num_pos_feats: int,
                                     temperature: float = 10000.0,
                                     device=None) -> torch.Tensor:
    """3-D (frame, row, column) sine embedding, f32 (b, C, n_f, h, w): the
    rows and the columns get ``C // 8 * 3`` channels each and the frames the
    rest, in the order frame, row, column; each part interleaves sin and cos
    of the 1-based position over ``temperature ** (2 * (i // 2) / part)``
    (reference ``position_encoding.py:61-111``)."""
    spatial = num_pos_feats // 8 * 3

    def encode(n: int, feats: int) -> torch.Tensor:
        pos = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        dim_t = torch.arange(feats, dtype=torch.float32, device=device)
        dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / feats)
        p = pos[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], dim=-1).reshape(n, -1)

    z = encode(n_f, num_pos_feats - 2 * spatial)[:, None, None].expand(n_f, h, w, -1)
    y = encode(h, spatial)[None, :, None].expand(n_f, h, w, -1)
    x = encode(w, spatial)[None, None].expand(n_f, h, w, -1)
    pos = torch.cat([z, y, x], dim=-1).permute(3, 0, 1, 2)          # (C, n_f, h, w)
    return pos[None].expand(b, -1, -1, -1, -1)
