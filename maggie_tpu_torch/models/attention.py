"""Mask2Former-style attention layers (port of ``maggie_tpu/models/attention.py``;
reference ``module/mask_attention.py:9-206``). Seq-first tensors (L, B, E).

Multi-head attention is written from plain matmuls and a softmax rather than
``nn.MultiheadAttention``: a query row whose keys are all masked gives zeros
here, where torch gives NaN (``maggie_tpu/models/attention.py:68-73``), so
padded instance slots stay finite. Every row with at least one key is the
same as torch's. Logits and softmax run in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import parallel
from .layers import LayerNorm, Linear, xavier_


class TorchMHA(nn.Module):
    """``nn.MultiheadAttention`` parameters (packed in-proj, ``out_proj``);
    returns (output (L, B, E), attention averaged over heads (B, L, S))."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def init_params(self, g: torch.Generator) -> None:
        xavier_(self.in_proj_weight, self.embed_dim, 3 * self.embed_dim, g)
        nn.init.zeros_(self.in_proj_bias)

    def forward(self, query, key, value, attn_mask=None, key_padding_mask=None):
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        dt = query.dtype
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)
        q = F.linear(query, w[:e], b[:e])
        k = F.linear(key.to(dt), w[e:2 * e], b[e:2 * e])
        v = F.linear(value.to(dt), w[2 * e:], b[2 * e:])
        L, B, _ = q.shape
        S = k.shape[0]
        q = q.reshape(L, B, h, hd).permute(1, 2, 0, 3) * (hd ** -0.5)   # (B, h, L, hd)
        k = k.reshape(S, B, h, hd).permute(1, 2, 0, 3)
        v = v.reshape(S, B, h, hd).permute(1, 2, 0, 3)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))  # (B, h, L, S)
        masked = None
        if attn_mask is not None:  # bool (B, L, S) or (L, S); True = disallow
            masked = attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
        if key_padding_mask is not None:  # bool (B, S); True = ignore
            kp = key_padding_mask[:, None, None, :]
            masked = kp if masked is None else (masked | kp)
        if masked is not None:
            logits = logits.masked_fill(masked, float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        if masked is not None:
            all_masked = torch.isneginf(logits).all(dim=-1, keepdim=True)
            attn = attn.masked_fill(all_masked, 0.0)
        out = torch.matmul(attn.to(v.dtype), v)                          # (B, h, L, hd)
        out = out.permute(2, 0, 1, 3).reshape(L, B, e)
        return self.out_proj(out), attn.mean(dim=1)


class SelfAttentionLayer(nn.Module):
    """Post-norm self-attention (reference ``mask_attention.py:9-64``)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.self_attn = TorchMHA(d_model, nhead)
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, tgt_key_padding_mask=None, query_pos=None):
        qk = tgt if query_pos is None else tgt + query_pos
        tgt2, _ = self.self_attn(qk, qk, tgt, key_padding_mask=tgt_key_padding_mask)
        return self.norm(tgt + tgt2)


class CrossAttentionLayer(nn.Module):
    """Post-norm cross-attention returning the attention matrix
    (reference ``mask_attention.py:67-137``)."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.multihead_attn = TorchMHA(d_model, nhead)
        self.norm = LayerNorm(d_model)

    def forward(self, tgt, memory, memory_mask=None, memory_key_padding_mask=None,
                pos=None, query_pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        tgt2, atten = self.multihead_attn(q, k, memory, attn_mask=memory_mask,
                                          key_padding_mask=memory_key_padding_mask)
        return self.norm(tgt + tgt2), atten


def dropout(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p (a uniform
    draw from ``generator`` at or above p) and scale it by 1 / (1 - p). Dim 0
    is the batch's: under data parallelism the draw is the global batch's,
    of which this rank keeps its rows."""
    u = parallel.shard_draw(lambda shape: torch.rand(shape, generator=generator,
                                                     device=generator.device), x.shape)
    u = u.to(x.device)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class FFNLayer(nn.Module):
    """Post-norm FFN (reference ``mask_attention.py:140-180``). In train mode
    with ``dropout`` > 0, dropout after the ReLU and after ``linear2``, drawn
    from the ``generator`` the caller passes."""

    def __init__(self, d_model: int, dim_feedforward: int = 2048, dropout: float = 0.0):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm = LayerNorm(d_model)
        self.dropout = float(dropout)

    def _drop(self, x: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        if not (self.training and self.dropout > 0):
            return x
        if generator is None:
            raise ValueError("FFNLayer dropout in train mode needs a torch.Generator")
        return dropout(x, self.dropout, generator)

    def forward(self, tgt: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self._drop(F.relu(self.linear1(tgt)), generator)
        return self.norm(tgt + self._drop(self.linear2(x), generator))
