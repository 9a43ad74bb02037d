"""Carry the JAX package's variables across to the port, and back.

``convert_jax(flat, model)`` takes the JAX variables as a flat dict
``{"params/encoder_mod/...": array, "batch_stats/...", "spectral/..."}`` and
returns a ``state_dict`` for the port's ``model`` (unfolded, so that a JAX
train state's spectral u/v load too; ``flatten_collections`` makes the flat
dict from a train state's ``params``, ``batch_stats`` and ``spectral`` trees).
It inverts the JAX package's torch-checkpoint converter
(``maggie_tpu/utils/convert_torch.py::Converter.maggie``, ``:270-288``) for the
flagship config, with the port's own copy of the key map: the port's modules
carry the original torch reference's ``state_dict`` names, so the map is the
reference's. ``to_jax`` is the reverse map, for holding the port's tensors
(parameters, their gradients, running statistics, u/v) against the JAX
package's after a step.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn


# JAX -> torch axis permutations (None: the same layout)
_conv_w = (3, 2, 0, 1)     # JAX HWIO -> torch conv (O, I, kh, kw)
_convT_w = (2, 3, 0, 1)    # JAX HWIO -> torch transposed conv (I, O, kh, kw)
_spconv_w = (3, 0, 1, 2)   # JAX HWIO -> spconv 2 (O, kh, kw, I)
_linear_w = (1, 0)         # flax Dense (in, out) -> torch Linear (out, in)
_same = None


class _KeyMap:
    """(torch key, JAX flat key, JAX -> torch axis permutation) triples,
    method for method the counterpart of ``Converter``."""

    def __init__(self):
        self.entries: list[tuple[str, str, tuple | None]] = []

    def put(self, tkey: str, jkey: str, fn: tuple | None = _same):
        self.entries.append((tkey, jkey, fn))

    def bn(self, tkey, dst, masked=False):
        sub = dst if masked else f"{dst}/bn"
        self.put(f"{tkey}.weight", f"params/{sub}/scale")
        self.put(f"{tkey}.bias", f"params/{sub}/bias")
        self.put(f"{tkey}.running_mean", f"batch_stats/{sub}/mean")
        self.put(f"{tkey}.running_var", f"batch_stats/{sub}/var")

    def snconv(self, tkey, dst, fn=_conv_w):
        self.put(f"{tkey}.module.weight_bar", f"params/{dst}/weight_bar", fn)
        self.put(f"{tkey}.module.weight_u", f"spectral/{dst}/u")
        self.put(f"{tkey}.module.weight_v", f"spectral/{dst}/v")
        self.put(f"{tkey}.module.bias", f"params/{dst}/bias")

    def conv(self, tkey, dst, fn=_conv_w):
        self.put(f"{tkey}.weight", f"params/{dst}/weight", fn)
        self.put(f"{tkey}.bias", f"params/{dst}/bias")

    def dense(self, tkey, dst):
        self.put(f"{tkey}.weight", f"params/{dst}/kernel", _linear_w)
        self.put(f"{tkey}.bias", f"params/{dst}/bias")

    def layer_norm(self, tkey, dst):
        self.put(f"{tkey}.weight", f"params/{dst}/scale")
        self.put(f"{tkey}.bias", f"params/{dst}/bias")

    def mha(self, tkey, dst):
        for t, j in (("in_proj_weight", "in_proj_weight"), ("in_proj_bias", "in_proj_bias"),
                     ("out_proj.weight", "out_proj_weight"), ("out_proj.bias", "out_proj_bias")):
            self.put(f"{tkey}.{t}", f"params/{dst}/{j}")

    def enc_basic_block(self, tkey, dst):
        self.snconv(f"{tkey}.conv1", f"{dst}/conv1")
        self.bn(f"{tkey}.bn1", f"{dst}/bn1")
        self.snconv(f"{tkey}.conv2", f"{dst}/conv2")
        self.bn(f"{tkey}.bn2", f"{dst}/bn2")
        # stride != 1: Sequential(AvgPool, SNConv, BN); else Sequential(SNConv, BN)
        self.snconv(f"{tkey}.downsample.1", f"{dst}/downsample_conv")
        self.bn(f"{tkey}.downsample.2", f"{dst}/downsample_bn")
        self.snconv(f"{tkey}.downsample.0", f"{dst}/downsample_conv")
        self.bn(f"{tkey}.downsample.1", f"{dst}/downsample_bn")

    def dec_basic_block(self, tkey, dst, stride):
        self.snconv(f"{tkey}.conv1", f"{dst}/conv1", _convT_w if stride > 1 else _conv_w)
        self.bn(f"{tkey}.bn1", f"{dst}/bn1")
        self.snconv(f"{tkey}.conv2", f"{dst}/conv2")
        self.bn(f"{tkey}.bn2", f"{dst}/bn2")
        self.snconv(f"{tkey}.upsample.1", f"{dst}/upsample_conv")
        self.bn(f"{tkey}.upsample.2", f"{dst}/upsample_bn")
        self.snconv(f"{tkey}.upsample.0", f"{dst}/upsample_conv")
        self.bn(f"{tkey}.upsample.1", f"{dst}/upsample_bn")

    def res_layer(self, tkey, dst, blocks, enc, stride=2):
        for i in range(blocks):
            if enc:
                self.enc_basic_block(f"{tkey}.{i}", f"{dst}/block{i}")
            else:
                self.dec_basic_block(f"{tkey}.{i}", f"{dst}/block{i}", stride if i == 0 else 1)

    def encoder(self, tkey, dst):
        base = f"{dst}/backbone"
        self.put(f"{tkey}.mask_embed_layer.weight", f"params/{dst}/mask_embed_layer/embedding")
        for c in (1, 2, 3):
            self.snconv(f"{tkey}.conv{c}", f"{base}/conv{c}")
            self.bn(f"{tkey}.bn{c}", f"{base}/bn{c}")
        for name, blocks in (("layer1", 3), ("layer2", 4), ("layer3", 4),
                             ("layer_bottleneck", 2)):
            self.res_layer(f"{tkey}.{name}", f"{base}/{name}", blocks, enc=True)
        for i in range(5):
            self.snconv(f"{tkey}.shortcut.{i}.0", f"{base}/shortcut_{i}/conv0")
            self.bn(f"{tkey}.shortcut.{i}.2", f"{base}/shortcut_{i}/bn0")
            self.snconv(f"{tkey}.shortcut.{i}.3", f"{base}/shortcut_{i}/conv1")
            self.bn(f"{tkey}.shortcut.{i}.5", f"{base}/shortcut_{i}/bn1")

    def aspp(self, tkey, dst):
        for i in range(1, 6):
            self.conv(f"{tkey}.aspp{i}", f"{dst}/aspp{i}")
            self.bn(f"{tkey}.aspp{i}_bn", f"{dst}/aspp{i}_bn")
        self.conv(f"{tkey}.conv2", f"{dst}/conv2")
        self.bn(f"{tkey}.bn2", f"{dst}/bn2")

    def instance_matte_decoder(self, tkey, dst, n_block):
        self.dense(f"{tkey}.feat_proj.layers.0", f"{dst}/feat_proj/layer0")
        for i in range(n_block):
            self.mha(f"{tkey}.sa_layers.{i}.self_attn", f"{dst}/sa_{i}/self_attn")
            self.layer_norm(f"{tkey}.sa_layers.{i}.norm", f"{dst}/sa_{i}/norm/ln")
            self.mha(f"{tkey}.token_feat_ca_layers.{i}.multihead_attn",
                     f"{dst}/token_feat_ca_{i}/multihead_attn")
            self.layer_norm(f"{tkey}.token_feat_ca_layers.{i}.norm",
                            f"{dst}/token_feat_ca_{i}/norm/ln")
            self.dense(f"{tkey}.mlp_layers.{i}.linear1", f"{dst}/mlp_{i}/linear1")
            self.dense(f"{tkey}.mlp_layers.{i}.linear2", f"{dst}/mlp_{i}/linear2")
            self.layer_norm(f"{tkey}.mlp_layers.{i}.norm", f"{dst}/mlp_{i}/norm/ln")
            self.mha(f"{tkey}.feat_token_ca_layers.{i}.multihead_attn",
                     f"{dst}/feat_token_ca_{i}/multihead_attn")
            self.layer_norm(f"{tkey}.feat_token_ca_layers.{i}.norm",
                            f"{dst}/feat_token_ca_{i}/norm/ln")
        self.mha(f"{tkey}.final_token_feat_ca.multihead_attn",
                 f"{dst}/final_token_feat_ca/multihead_attn")
        self.layer_norm(f"{tkey}.final_token_feat_ca.norm", f"{dst}/final_token_feat_ca/norm/ln")
        self.dense(f"{tkey}.final_mlp.layers.0", f"{dst}/final_mlp/layer0")
        self.layer_norm(f"{tkey}.decoder_norm", f"{dst}/decoder_norm")
        self.put(f"{tkey}.query_feat.weight", f"params/{dst}/query_feat")
        self.put(f"{tkey}.id_embedding.weight", f"params/{dst}/id_embedding/embedding")
        self.conv(f"{tkey}.conv.0", f"{dst}/conv_0")
        self.bn(f"{tkey}.conv.1", f"{dst}/conv_bn0")
        self.conv(f"{tkey}.conv.3", f"{dst}/conv_1")
        self.bn(f"{tkey}.conv.4", f"{dst}/conv_bn1")

    def sparse_decoder(self, tkey, dst, n_block):
        self.res_layer(f"{tkey}.layer1", f"{dst}/layer1", 2, enc=False)
        self.res_layer(f"{tkey}.layer2", f"{dst}/layer2", 3, enc=False)
        self.instance_matte_decoder(f"{tkey}.refine_OS8", f"{dst}/refine_OS8_mod", n_block)
        self.dense(f"{tkey}.inst_spec_layer.linear1", f"{dst}/inst_spec_layer/linear1")
        self.dense(f"{tkey}.inst_spec_layer.linear2", f"{dst}/inst_spec_layer/linear2")
        self.layer_norm(f"{tkey}.inst_spec_layer.norm", f"{dst}/inst_spec_layer/norm/ln")
        for seq, convs, bns in (
                ("layer3", ((0, "layer3_inv"), (3, "layer3_subm")), ((1, "layer3_bn"),)),
                ("guidance_layer", ((0, "guidance_conv1"), (3, "guidance_conv2")),
                 ((1, "guidance_bn"),)),
                ("layer3_smooth", ((0, "layer3_smooth_conv"),), ((2, "layer3_smooth_bn"),)),
                ("layer4", ((0, "layer4_inv"), (3, "layer4_subm")), ((1, "layer4_bn"),)),
                ("layer4_smooth", ((0, "layer4_smooth_conv"),), ((2, "layer4_smooth_bn"),)),
                ("layer5", ((0, "layer5_inv"), (3, "layer5_subm")), ((1, "layer5_bn"),)),
                ("layer5_smooth", ((0, "layer5_smooth_conv"),), ((2, "layer5_smooth_bn"),)),
                ("refine_OS4", ((0, "refine_OS4_conv1"), (3, "refine_OS4_conv2")),
                 ((1, "refine_OS4_bn"),)),
                ("refine_OS1", ((0, "refine_OS1_conv1"), (3, "refine_OS1_conv2")),
                 ((1, "refine_OS1_bn"),))):
            for i, name in convs:
                self.conv(f"{tkey}.{seq}.{i}", f"{dst}/{name}", _spconv_w)
            for i, name in bns:
                self.bn(f"{tkey}.{seq}.{i}", f"{dst}/{name}", masked=True)


def key_map(n_block: int = 2) -> list[tuple[str, str, tuple | None]]:
    """The flagship MaGGIe map: encoder res_shortcut_embed_29, ASPP, decoder
    res_shortcut_inst_matt_spconv_22 with ``n_block`` attention blocks."""
    km = _KeyMap()
    km.encoder("encoder", "encoder_mod")
    km.aspp("aspp", "aspp_mod")
    km.sparse_decoder("decoder", "decoder_mod", n_block)
    return km.entries


def convert_jax(flat: dict, model: nn.Module, n_block: int = 2) -> dict[str, torch.Tensor]:
    """JAX flat variables -> the port's ``state_dict``. Raises if a port tensor
    gets no value, a JAX array is left over, or a shape disagrees."""
    sd = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for tkey, jkey, fn in key_map(n_block):
        if tkey not in sd or tkey in out:
            continue
        if jkey not in flat:
            continue
        value = np.asarray(flat[jkey])
        value = torch.from_numpy(np.array(value if fn is None else np.transpose(value, fn)))
        if tuple(value.shape) != tuple(sd[tkey].shape):
            raise ValueError(f"{jkey} -> {tkey}: shape {tuple(value.shape)} != "
                             f"{tuple(sd[tkey].shape)}")
        out[tkey] = value.to(sd[tkey].dtype)
        used.add(jkey)
    for k, v in sd.items():
        if k not in out and k.endswith("num_batches_tracked"):
            out[k] = torch.zeros_like(v)
    missing = sorted(k for k in sd if k not in out)
    leftover = sorted(k for k in flat if k not in used)
    if missing or leftover:
        raise KeyError(f"convert_jax: {len(missing)} port tensors without a JAX value "
                       f"(e.g. {missing[:5]}), {len(leftover)} JAX arrays unused "
                       f"(e.g. {leftover[:5]})")
    return out


def flatten_collections(**trees) -> dict:
    """Nested collections (``params=..., batch_stats=..., spectral=...``, as a
    JAX train state holds them, leaves convertible by ``np.asarray``) -> the
    flat dict ``convert_jax`` reads."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            flat[prefix] = np.asarray(node)
    for name, tree in trees.items():
        walk(name, tree)
    return flat


def to_jax(tensors: Mapping[str, torch.Tensor], n_block: int = 2) -> dict[str, np.ndarray]:
    """Port tensors under their ``state_dict`` names (parameters, their
    gradients, buffers) -> ``{JAX flat key: array}`` in the JAX layout. Names
    without a JAX counterpart (``num_batches_tracked``) are left out."""
    out = {}
    for tkey, jkey, fn in key_map(n_block):
        if tkey in tensors and jkey not in out:
            value = tensors[tkey].detach().float().cpu().numpy()
            out[jkey] = value if fn is None else np.transpose(value, np.argsort(fn))
    return out
