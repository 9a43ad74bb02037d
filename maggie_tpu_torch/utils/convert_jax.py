"""Carry the JAX package's variables across to the port, and back.

``convert_jax(flat, model)`` takes the JAX variables as a flat dict
``{"params/encoder_mod/...": array, "batch_stats/...", "spectral/..."}`` and
returns a ``state_dict`` for the port's ``model`` (unfolded, so that a JAX
train state's spectral u/v load too; ``flatten_collections`` makes the flat
dict from a train state's ``params``, ``batch_stats`` and ``spectral`` trees).
It inverts the JAX package's torch-checkpoint converter
(``maggie_tpu/utils/convert_torch.py::Converter.maggie``, ``:270-288``) for the
image and the video MaGGIe, the dense InstMatt decoder and the MGM family (MGM
and TCVOM), with the port's own copy of the key map: the port's modules carry
the original torch reference's ``state_dict`` names, so the map is the
reference's. The map is chosen by the model's own names (``_layout``): the
MaGGIe encoder (``mask_embed_layer``) sits under ``encoder_mod/backbone`` in
JAX, the MGM encoder directly under ``encoder_mod`` (``:256-268``).

``atten_stride`` > 1 adds the instance decoder's ``ori_feat_proj`` (a 1x1
conv, ``decoder.refine_OS8.ori_feat_proj.weight`` here, JAX
``refine_OS8_mod/ori_feat_proj/weight``) to the image, dense InstMatt and
video decoders. This module maps it; no ``.pth`` reader on either side does
(the JAX package's ``convert_torch.py`` has no entry for it, and no released
checkpoint with the stride is known), so such a model's weights come across
from the JAX package only, and ``checkpoint.load_model_weights`` refuses a
torch file without it.

SparseMat's map is the port's own (``_KeyMap.sparsemat``): its torch names
mirror the JAX package's, because the reference's SparseMat names cannot be
read here and the JAX package's converter maps no SparseMat key. So a released
SparseMat ``.pth`` is not known to load into the port; its weights come across
from the JAX package only, through this module. ``to_jax`` is the reverse map, for holding the port's tensors
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

    def encoder(self, tkey, dst, embed=True):
        base = f"{dst}/backbone" if embed else dst
        if embed:
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
        self.conv(f"{tkey}.ori_feat_proj", f"{dst}/ori_feat_proj")    # atten_stride > 1

    def video_decoder(self, tkey, dst):
        """The video decoder's own modules (``Converter.maggie(video=True)``)."""
        self.conv(f"{tkey}.os8_temp_module.ih.0", f"{dst}/os8_temp_module/ih_conv")
        self.conv(f"{tkey}.os8_temp_module.hh.0", f"{dst}/os8_temp_module/hh_conv")
        self.snconv(f"{tkey}.diff_module.0", f"{dst}/diff_module/conv1")
        self.bn(f"{tkey}.diff_module.1", f"{dst}/diff_module/bn1")
        self.snconv(f"{tkey}.diff_module.3", f"{dst}/diff_module/conv2")
        self.bn(f"{tkey}.diff_module.4", f"{dst}/diff_module/bn2")
        self.conv(f"{tkey}.diff_module.6", f"{dst}/diff_module/conv3")

    def refine_head(self, tkey, dst):
        """Dense head ``Sequential(conv, bn, lrelu, conv)`` (``Converter.refine_head``)."""
        self.conv(f"{tkey}.0", f"{dst}/conv1")
        self.bn(f"{tkey}.1", f"{dst}/bn")
        self.conv(f"{tkey}.3", f"{dst}/conv2")

    def mgm_decoder(self, tkey, dst):
        """``res_shortcut_22`` (``Converter.mgm_decoder``, ``:234-241``) and
        ``res_shortcut_fam_22``'s FAM convs."""
        for name, blocks in (("layer1", 2), ("layer2", 3), ("layer3", 3), ("layer4", 2)):
            self.res_layer(f"{tkey}.{name}", f"{dst}/{name}", blocks, enc=False)
        self.snconv(f"{tkey}.conv1", f"{dst}/conv1", _convT_w)
        self.bn(f"{tkey}.bn1", f"{dst}/bn1")
        for h in ("OS8", "OS4", "OS1"):
            self.refine_head(f"{tkey}.refine_{h}", f"{dst}/refine_{h}")
        for c in ("key_conv", "query_conv", "value_conv"):
            self.conv(f"{tkey}.fam.{c}", f"{dst}/fam/{c}")

    def inst_dense_decoder(self, tkey, dst, n_block):
        """``res_shortcut_inst_matt_22`` (the torch names of
        ``Converter.inst_dense_decoder``, ``convert_torch.py:243-253``)."""
        for name, blocks in (("layer1", 2), ("layer2", 3), ("layer3", 3), ("layer4", 2)):
            self.res_layer(f"{tkey}.{name}", f"{dst}/{name}", blocks, enc=False)
        self.instance_matte_decoder(f"{tkey}.refine_OS8", f"{dst}/refine_OS8_mod", n_block)
        self.snconv(f"{tkey}.conv1", f"{dst}/conv1", _convT_w)
        self.bn(f"{tkey}.bn1", f"{dst}/bn1")
        for h in ("OS4", "OS1"):
            self.refine_head(f"{tkey}.refine_{h}", f"{dst}/refine_{h}")

    def sparsemat(self):
        """SparseMat: ``lpn`` (MobileNetV2 and the MODNet branch; BatchNorms
        under the JAX package's ``BatchNorm`` wrapper) and ``shm`` (spconv-
        layout convs, masked BatchNorms; the context gate's plain convs).
        The torch names mirror the JAX package's, since the reference's
        cannot be read here and ``convert_torch.py`` maps none of them."""
        lpn, bb = "lpn_mod", "lpn_mod/backbone"
        for i in range(19):
            t, d = f"lpn.backbone.features.{i}", f"{bb}/features_{i}"
            self.conv(f"{t}.conv", f"{d}/conv")
            self.bn(f"{t}.bn", f"{d}/bn")
            for c in ("pw", "dw", "pw_linear"):
                self.conv(f"{t}.{c}", f"{d}/{c}")
                self.bn(f"{t}.{c}_bn", f"{d}/{c}_bn")
        dec = f"{lpn}/decoder"
        for fc in ("fc1", "fc2"):
            self.put(f"lpn.decoder.se_block.{fc}.weight", f"params/{dec}/se_block/{fc}/kernel",
                     _linear_w)
        for name in ("p32x", "conv_dec16x_0", "conv_dec16x_1", "p16x", "conv_dec8x_0",
                     "conv_dec8x_1", "p8x", "conv_dec4x_0", "conv_dec4x_1", "p4x",
                     "conv_dec2x_0", "conv_dec2x_1", "conv_dec2x_2", "p2x", "conv_dec1x_0",
                     "p1x", "p0x"):
            self.conv(f"lpn.decoder.{name}.conv", f"{dec}/{name}/conv")
            self.bn(f"lpn.decoder.{name}.ibn.bnorm", f"{dec}/{name}/ibn/bnorm")
        bb = "shm_mod/backbone"
        for i in (1, 2, 3):
            self.conv(f"shm.backbone.conv{i}", f"{bb}/conv{i}", _spconv_w)
            self.bn(f"shm.backbone.bn{i}", f"{bb}/bn{i}", masked=True)
        for layer in range(1, 5):
            for blk in range(2):
                t, d = f"shm.backbone.layer{layer}.{blk}", f"{bb}/layer{layer}_block{blk}"
                for c in ("conv1", "conv2", "downsample_conv"):
                    self.conv(f"{t}.{c}", f"{d}/{c}", _spconv_w)
                for n in ("bn1", "bn2", "downsample_bn"):
                    self.bn(f"{t}.{n}", f"{d}/{n}", masked=True)
        for c in ("conv_f", "conv_b", "conv_g"):
            self.conv(f"shm.ctx.{c}", f"shm_mod/ctx/{c}")
        for c in ("conv_up1", "conv_p8x", "conv_up2", "conv_p4x", "conv_up3", "conv_p2x",
                  "alpha_conv1", "alpha_conv2", "alpha_conv3"):
            self.conv(f"shm.decoder.{c}", f"shm_mod/decoder/{c}", _spconv_w)
        for n in ("conv_up1_bn", "conv_up2_bn", "conv_up3_bn"):
            self.bn(f"shm.decoder.{n}", f"shm_mod/decoder/{n}", masked=True)

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


def _layout(names) -> tuple[str, bool]:
    """(the decoder's kind, the MaGGIe encoder with its mask embedding?) of
    a model, read from its ``state_dict`` names or any part of them (its
    parameters, running statistics or u/v alone). The kinds:

    - ``"dummy"``: arch Dummy, its one parameter ``scale``;
    - ``"sparsemat"``: arch SparseMat (``lpn.``, ``shm.``);
    - ``"inst_dense"``: the dense InstMatt decoder ``res_shortcut_inst_matt_22``,
      told by ``decoder.conv1`` or ``decoder.bn1`` beside the instance
      decoder's own names under ``decoder.refine_OS8`` (the MGM decoder's
      ``refine_OS8`` is a head, ``.0``, ``.1``, ``.3``); a part of u/v alone
      shows neither and takes the MGM map, whose u/v entries are the same;
    - ``"dense"``: the MGM family's ``res_shortcut_22`` and TCVOM's FAM decoder
      (``decoder.conv1``, ``decoder.bn1``);
    - ``"sparse"``: MaGGIe's image and video decoders.

    The encoder is told by ``encoder.mask_embed_layer``, or by its spectral
    weights without it; in a part without parameters by the decoder, as
    every config pairs them (the MaGGIe decoders, the dense InstMatt one
    included, with the embedding; the MGM family without)."""
    names = list(names)
    if "scale" in names:
        return "dummy", False
    if any(k.startswith(("lpn.", "shm.")) for k in names):
        return "sparsemat", False
    dense = any(k.startswith(("decoder.conv1.", "decoder.bn1.")) for k in names)
    inst = dense and any(k.startswith("decoder.refine_OS8.") and k.split(".")[2] not in ("0", "1", "3")
                         for k in names)
    kind = "inst_dense" if inst else "dense" if dense else "sparse"
    if any(k.startswith("encoder.mask_embed_layer.") for k in names):
        return kind, True
    if any(k.startswith("encoder.") and k.endswith(".weight_bar") for k in names):
        return kind, False
    return kind, kind != "dense"


def key_map(n_block: int = 2, names=()) -> list[tuple[str, str, tuple | None]]:
    """The map of the model whose ``state_dict`` names are (or include)
    ``names`` (``_layout``): Dummy's ``scale``, SparseMat's LPN and SHM, or the encoder
    res_shortcut_embed_29 or res_shortcut_29, ASPP, and the decoder:
    MaGGIe's res_shortcut_inst_matt_spconv_22 with ``n_block`` attention
    blocks and the video decoder's ConvGRU and diff module, the dense
    InstMatt decoder res_shortcut_inst_matt_22, or MGM's res_shortcut_22
    with TCVOM's FAM (entries a model lacks are skipped by every reader)."""
    kind, embed = _layout(names)
    km = _KeyMap()
    if kind == "dummy":
        km.put("scale", "params/scale")
        return km.entries
    if kind == "sparsemat":
        km.sparsemat()
        return km.entries
    km.encoder("encoder", "encoder_mod", embed)
    km.aspp("aspp", "aspp_mod")
    if kind == "dense":
        km.mgm_decoder("decoder", "decoder_mod")
    elif kind == "inst_dense":
        km.inst_dense_decoder("decoder", "decoder_mod", n_block)
    else:
        km.sparse_decoder("decoder", "decoder_mod", n_block)
        km.video_decoder("decoder", "decoder_mod")
    return km.entries


def convert_jax(flat: dict, model: nn.Module, n_block: int = 2) -> dict[str, torch.Tensor]:
    """JAX flat variables -> the port's ``state_dict``. Raises if a port tensor
    gets no value, a JAX array is left over, or a shape disagrees."""
    sd = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for tkey, jkey, fn in key_map(n_block, sd):
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
    for tkey, jkey, fn in key_map(n_block, tensors):
        if tkey in tensors and jkey not in out:
            value = tensors[tkey].detach().float().cpu().numpy()
            out[jkey] = value if fn is None else np.transpose(value, np.argsort(fn))
    return out
