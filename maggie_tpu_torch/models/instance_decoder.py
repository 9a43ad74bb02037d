"""Instance-query attention decoder (port of
``maggie_tpu/models/instance_decoder.py``; reference
``module/instance_matte_decoder.py``).

Learnable instance tokens and a shared ID-embedding table painted onto both the
tokens and the feature-map positions, ``n_block`` rounds of (token<-feat
cross-attention, FFN, token self-attention, feat<-token cross-attention), a final
token<-feat cross-attention, and the token-feature product that gives one matte
logit map per instance slot.

This port runs ``atten_stride`` 1. With ``use_temp_pe`` the positional
embedding's last ``C - 2 * (C // 8 * 3)`` channels are the frame's sine
embedding (``position_encoding.py``) and the ID table is that much narrower
(``maggie_tpu/models/instance_decoder.py:52-55,74-79,103-117``); no config
reaches it (``maggie_tpu/models/decoder_sparse.py:89`` passes False). The video
decoder passes ``aggregate_mem_fn``, its ConvGRU memory
(``maggie_tpu/models/instance_decoder.py:222-231``). Train mode adds the
attention supervision by the GT masks (the max-attention loss) or, with
``use_mask_atten``, attention masked by the guidance masks.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .. import parallel
from .attention import CrossAttentionLayer, FFNLayer, SelfAttentionLayer
from .layers import MLP, BatchNorm, Conv2d, Embedding, LayerNorm, per_frame
from .position_encoding import temporal_position_embedding_sine
from ..ops.resize import avg_pool2d, resize_any_shape


class InstanceMatteDecoder(nn.Module):
    def __init__(self, input_dim: int = 256, attention_dim: int = 256, n_block: int = 2,
                 n_head: int = 4, output_dim: int = 32, max_inst: int = 10,
                 use_id_pe: bool = True, use_temp_pe: bool = False):
        super().__init__()
        self.attention_dim, self.n_block, self.max_inst = attention_dim, n_block, max_inst
        self.use_id_pe = use_id_pe
        self.n_temp = attention_dim - 2 * (attention_dim // 8 * 3) if use_temp_pe else 0
        self.feat_proj = MLP(input_dim, attention_dim, attention_dim, 1)
        self.query_feat = Embedding(max_inst, attention_dim)
        self.id_embedding = Embedding(max_inst + 1, attention_dim - self.n_temp)
        self.token_feat_ca_layers = nn.ModuleList(
            CrossAttentionLayer(attention_dim, n_head) for _ in range(n_block))
        self.mlp_layers = nn.ModuleList(
            FFNLayer(attention_dim, attention_dim) for _ in range(n_block))
        self.sa_layers = nn.ModuleList(
            SelfAttentionLayer(attention_dim, n_head) for _ in range(n_block))
        self.feat_token_ca_layers = nn.ModuleList(
            CrossAttentionLayer(attention_dim, n_head) for _ in range(n_block))
        self.final_token_feat_ca = CrossAttentionLayer(attention_dim, n_head)
        self.final_mlp = MLP(attention_dim, attention_dim, output_dim, 1)
        self.decoder_norm = LayerNorm(output_dim)
        # one conv stack shared by both applications (reference self.conv, :81-88)
        self.conv = nn.Sequential(
            Conv2d(attention_dim, attention_dim, 3, padding=1, bias=False),
            BatchNorm(attention_dim), nn.LeakyReLU(0.2),
            Conv2d(attention_dim, output_dim, 1, bias=False),
            BatchNorm(output_dim), nn.LeakyReLU(0.2))

    def _attention_masks(self, gm: torch.Tensor, b: int, n_f: int, h: int, w: int):
        """Train mode (``maggie_tpu/models/instance_decoder.py:135-154``): from
        (b, n_f, n_i_in, h, w) masks at the feature size, the cross-attention
        padding mask (True = disallowed; an instance with an empty mask attends
        everywhere) and the f32 guidance map of the attention loss, both
        (b, max_inst, h*w*n_f) with the frame index fastest."""
        n_i = self.max_inst
        g = gm.transpose(0, 1).reshape(n_f * b, gm.shape[2], h * w)
        if g.shape[1] < n_i:
            g = torch.cat([g, g.new_zeros(n_f * b, n_i - g.shape[1], h * w)], dim=1)
        g = g > 0
        invalid = g.sum(dim=-1) == 0
        padding = ~(g | invalid[:, :, None])

        def seq(t):
            return t.reshape(n_f, b, n_i, h * w).permute(1, 2, 3, 0).reshape(b, n_i, h * w * n_f)
        return seq(padding), seq(g).float()

    def forward(self, feat: torch.Tensor, mask: torch.Tensor, gt_mask: torch.Tensor | None = None,
                use_mask_atten: bool = False, aggregate_mem_fn=None):
        """feat (b*n_f, C, h, w); mask (b, n_f, n_i, H, W) guidance masks.

        Returns (logits (b*n_f, max_inst, h, w) f32, smoothed features
        (b*n_f, output_dim, h, w), tokens (b, max_inst, output_dim) f32,
        attention loss, hidden state). ``aggregate_mem_fn`` maps the attended
        maps (b, n_f, C, h, w) to (mixed maps, hidden state): the shared conv
        stack then runs on the memory-free maps, which are the returned
        features, and on the mixed maps, which give the logits; without it
        the hidden state is None. In train mode, ``gt_mask`` (b, n_f, n_i, H, W) 0/1
        supervises the token->feature attention maps (reference
        ``compute_atten_loss``, ``instance_matte_decoder.py:101-109``): the loss
        is their mass outside each instance's GT mask, averaged over the
        ``n_block + 1`` layers; ``use_mask_atten`` instead masks that attention
        with the guidance masks. In eval the loss is 0."""
        dt = feat.dtype
        b, n_f = mask.shape[:2]
        h, w = feat.shape[2], feat.shape[3]
        c = self.attention_dim
        if w < mask.shape[-1]:
            # binary-preserving downsample: avg-pool then > 0 (resizeAnyShape)
            mask = (avg_pool2d(mask.float(), int(round(mask.shape[-1] / w))) > 0).to(mask.dtype)
        atten_padding = guidance = None
        if self.training:
            gm = mask if use_mask_atten else gt_mask
            if gm is not None:
                if not use_mask_atten and gm.shape[-1] != w:
                    gm = resize_any_shape(gm, scale_factor=w / gm.shape[-1], use_max_pool=True)
                atten_padding, guidance = self._attention_masks(gm, b, n_f, h, w)
        memory_mask = atten_padding if use_mask_atten else None
        supervise = self.training and not use_mask_atten and guidance is not None

        def atten_loss(att):
            vals = (guidance * att).sum(dim=2)
            gt = torch.where(guidance.sum(dim=2) == 0, 0.0, 1.0)
            return (gt - vals).sum() / (n_f * b * parallel.world())   # the global frames

        # paint instance IDs onto the feature map: max over instances of mask*id
        n_i_in = mask.shape[2]
        ids = torch.arange(1, n_i_in + 1, dtype=mask.dtype, device=mask.device)
        id_map = (mask * ids[None, None, :, None, None]).amax(dim=2).long()  # (b, n_f, h, w)
        id_table = self.id_embedding.weight
        fp = id_table[id_map]                                             # (b, n_f, h, w, c_id)
        token_pos = id_table[1:self.max_inst + 1][:, None].expand(-1, b, -1)
        if self.n_temp:
            # each frame's temporal embedding on its positions; the tokens
            # take frame 0's (maggie_tpu/models/instance_decoder.py:103-117)
            pe = temporal_position_embedding_sine(1, n_f, 1, 1, c, device=feat.device)
            temp = pe[0, :self.n_temp, :, 0, 0].t().to(id_table.dtype)    # (n_f, n_temp)
            fp = torch.cat([fp, temp[None, :, None, None].expand(b, n_f, h, w, -1)], dim=-1)
            token_pos = torch.cat([token_pos, temp[0].expand(self.max_inst, b, -1)], dim=-1)
        # sequence layout (h*w*n_f, b, c) with the frame index fastest
        fp = fp.permute(2, 3, 1, 0, 4).reshape(h * w * n_f, b, c).to(dt)
        token_pos = token_pos.to(dt)
        tokens = self.query_feat.weight.to(dt)[:, None].expand(-1, b, -1)   # (n_i, b, c)

        feat_seq = feat.reshape(b, n_f, feat.shape[1], h * w).permute(3, 1, 0, 2)
        feat_seq = self.feat_proj(feat_seq.reshape(h * w * n_f, b, feat.shape[1]))

        # token padding: instances with an empty input mask leave self-attention
        valid = mask.sum(dim=(1, 3, 4)) > 0                              # (b, n_i_in)
        if valid.shape[1] < self.max_inst:
            valid = torch.cat([valid, valid.new_zeros(b, self.max_inst - valid.shape[1])], 1)
        token_padding_mask = ~valid

        fp_or_none = fp if self.use_id_pe else None
        tp_or_none = token_pos if self.use_id_pe else None
        max_loss = 0.0
        for i in range(self.n_block):
            tokens, att = self.token_feat_ca_layers[i](tokens, feat_seq, memory_mask=memory_mask,
                                                       pos=fp_or_none, query_pos=tp_or_none)
            if supervise:
                max_loss = max_loss + atten_loss(att)
            tokens = self.mlp_layers[i](tokens)
            tokens = self.sa_layers[i](tokens, tgt_key_padding_mask=token_padding_mask,
                                       query_pos=token_pos)
            feat_seq, _ = self.feat_token_ca_layers[i](
                feat_seq, tokens, memory_key_padding_mask=token_padding_mask,
                pos=tp_or_none, query_pos=fp_or_none)
        tokens, att = self.final_token_feat_ca(tokens, feat_seq, memory_mask=memory_mask,
                                               pos=fp, query_pos=token_pos)
        if supervise:
            max_loss = max_loss + atten_loss(att)
        max_loss = max_loss / (self.n_block + 1)

        # (h*w*n_f, b, c) -> (b*n_f, c, h, w)
        fm = feat_seq.reshape(h, w, n_f, b, c).permute(3, 2, 4, 0, 1).reshape(b * n_f, c, h, w)
        # the conv stack is frame-local: in eval it runs one frame at a time
        # (layers.per_frame); train-mode BatchNorm needs the whole batch
        smooth = self.conv if self.training else (lambda t: per_frame(self.conv, t))
        hidden = None
        if aggregate_mem_fn is None:
            fm_out = out_feat = smooth(fm)
        else:
            fm_mem, hidden = aggregate_mem_fn(fm.reshape(b, n_f, c, h, w))
            out_feat = smooth(fm)
            fm_out = smooth(fm_mem.reshape(b * n_f, c, h, w))

        tk = self.final_mlp(tokens).permute(1, 0, 2)                     # (b, n_i, c_out)
        tk = self.decoder_norm(tk.float())                               # f32 (flax LayerNorm)
        fm5 = fm_out.reshape(b, n_f, fm_out.shape[1], h, w)
        # f32 product of the compute-dtype operands (maggie_tpu instance_decoder.py:240-241)
        out = torch.einsum("bqc,btchw->btqhw", tk.to(dt).float(), fm5.float())
        return out.reshape(b * n_f, self.max_inst, h, w), out_feat, tk, max_loss, hidden
