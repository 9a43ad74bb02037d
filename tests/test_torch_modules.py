"""The port's modules against ``maggie_tpu`` at 1e-5 (f32, CPU).

Weights are carried across by ``convert_jax`` (model-level modules) or by the
same layout transforms for stand-alone layers. 1e-5 absolute is the tolerance
the JAX package's own tests hold against the original torch code: the two
sides sum convolutions and matmuls in different orders (oneDNN vs XLA), which
moves f32 results by about 1e-6 at these sizes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maggie_tpu.models import attention as jatt, layers as jlayers, sparse_layers as jsp
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.models import attention as tatt, layers as tlayers, sparse_layers as tsp
from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
from test_torch_harness import (jax_cfg, jax_shapes, jax_variables, one_torch_thread,  # noqa: F401
                                port_cfg, port_from_flat, random_flat)

ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def models():
    """JAX and port models (oracle ladder, dense os1 shortcut) on one weight set."""
    jcfg = jax_cfg(sparse_mode="oracle")
    jm = jax_build_model(jcfg.model)
    flat = random_flat(jax_shapes(jm), seed=3)
    return jm, jax_variables(flat), port_from_flat(port_cfg(jcfg), flat)


def _apply(jm, jv, fn, *args):
    return jax.device_get(jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(jv, *args))


# ---------------------------------------------------------------- resize ops
def test_resize_ops():
    """Bilinear both ways (up and down), NHWC, legacy nearest and avg pool
    against maggie_tpu/ops/resize.py (1e-6: same matrices, other summation
    order) and bilinear against F.interpolate."""
    from maggie_tpu.ops import resize as jr
    from maggie_tpu_torch.ops import resize as tr
    x = np.random.RandomState(7).randn(2, 3, 9, 14).astype(np.float32)
    tx = torch.from_numpy(x)
    for size in ((18, 28), (5, 6), (72, 112)):
        for ac in (False, True):
            got = tr.resize_bilinear(tx, size, align_corners=ac)
            close(got.numpy(), jr.resize_bilinear(jnp.asarray(x), size, align_corners=ac), 1e-6)
            ref = torch.nn.functional.interpolate(tx, size=size, mode="bilinear", align_corners=ac)
            close(got.numpy(), ref.numpy(), 1e-5)
    nhwc = np.transpose(x, (0, 2, 3, 1))
    close(tr.resize_bilinear_nhwc(torch.from_numpy(nhwc), (18, 28), True).numpy(),
          jr.resize_bilinear_nhwc(jnp.asarray(nhwc), (18, 28), True), 1e-6)
    for size in ((72, 112), (20, 30)):
        np.testing.assert_array_equal(tr.resize_nearest(tx, size).numpy(),
                                      np.asarray(jr.resize_nearest(jnp.asarray(x), size)))
    close(tr.avg_pool2d(tx, 2).numpy(), jr.avg_pool2d(jnp.asarray(x), 2), 1e-6)


# ---------------------------------------------------------------- SN layers
@pytest.mark.parametrize("in_ch,out_ch,k,stride,bias", [(5, 8, 3, 2, True), (8, 8, 1, 1, False)])
def test_snconv(in_ch, out_ch, k, stride, bias):
    rs = np.random.RandomState(k)
    jmod = jlayers.SNConv(out_ch, (k, k), (stride, stride), (k // 2, k // 2), use_bias=bias)
    x = rs.randn(2, 12, 10, in_ch).astype(np.float32)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if bias:
        v = {**v, "params": {**v["params"], "bias": jnp.asarray(rs.randn(out_ch), jnp.float32)}}
    want = jmod.apply(v, jnp.asarray(x))
    mod = tlayers.SNConv(in_ch, out_ch, k, stride, k // 2, bias).eval()   # eval: no power step
    sd = {"module.weight_bar": torch.from_numpy(np.array(v["params"]["weight_bar"]))
          .permute(3, 2, 0, 1),
          "module.weight_u": torch.from_numpy(np.array(v["spectral"]["u"])),
          "module.weight_v": torch.from_numpy(np.array(v["spectral"]["v"]))}
    if bias:
        sd["module.bias"] = torch.from_numpy(np.array(v["params"]["bias"]))
    mod.load_state_dict(sd)
    close(to_nhwc(mod(nchw(x))), want)
    fold_spectral_norm(mod)
    assert "module.weight_u" not in mod.state_dict()
    close(to_nhwc(mod(nchw(x))), want)


@pytest.mark.parametrize("in_ch,out_ch", [(6, 4), (8, 8)])
def test_snconv_transpose(in_ch, out_ch):
    """k4 s2 p1 upsampler; I == O is the decoder's layer1/layer2 block0 case,
    where the port flattens (I, O*kh*kw) also when folding."""
    rs = np.random.RandomState(in_ch)
    jmod = jlayers.SNConvTranspose(out_ch)
    x = rs.randn(1, 5, 7, in_ch).astype(np.float32)
    v = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jmod.apply(v, jnp.asarray(x))
    mod = tlayers.SNConvTranspose(in_ch, out_ch).eval()
    mod.load_state_dict({
        "module.weight_bar": torch.from_numpy(np.array(v["params"]["weight_bar"]))
        .permute(2, 3, 0, 1),
        "module.weight_u": torch.from_numpy(np.array(v["spectral"]["u"])),
        "module.weight_v": torch.from_numpy(np.array(v["spectral"]["v"]))})
    got = mod(nchw(x))
    assert got.shape == (1, out_ch, 10, 14)
    close(to_nhwc(got), want)
    fold_spectral_norm(mod)
    close(to_nhwc(mod(nchw(x))), want)


# ---------------------------------------------------------------- model modules
def test_encoder(models):
    jm, jv, tm = models
    rs = np.random.RandomState(0)
    inp = np.concatenate([rs.rand(1, 64, 96, 3),
                          (rs.rand(1, 64, 96, 10) > 0.7) * (np.arange(10) < 2)], -1)
    inp = inp.astype(np.float32)
    emb, mid = _apply(jm, jv, lambda m, x: m.encoder(x), jnp.asarray(inp))
    with torch.inference_mode():
        temb, tmid = tm.encoder(nchw(inp))
    close(to_nhwc(temb), emb, msg="os32 embedding")
    for i, (a, b) in enumerate(zip(tmid["shortcut"], mid["shortcut"])):
        close(to_nhwc(a), b, msg=f"shortcut {i}")
    close(to_nhwc(tmid["image"]), mid["image"])


def test_aspp(models):
    jm, jv, tm = models
    x = np.random.RandomState(1).randn(1, 4, 6, 512).astype(np.float32)
    want = _apply(jm, jv, lambda m, x: m.aspp(x), jnp.asarray(x))
    with torch.inference_mode():
        close(to_nhwc(tm.aspp(nchw(x))), want)


def test_decoder_upsampling_layers(models):
    jm, jv, tm = models
    x = np.random.RandomState(2).randn(1, 3, 4, 512).astype(np.float32)
    want = _apply(jm, jv, lambda m, x: m.decoder.layer2(m.decoder.layer1(x)), jnp.asarray(x))
    with torch.inference_mode():
        got = tm.decoder.layer2(tm.decoder.layer1(nchw(x)))
    close(to_nhwc(got), want)


def test_instance_matte_decoder(models):
    jm, jv, tm = models
    rs = np.random.RandomState(3)
    z = rs.randn(1, 8, 12, 128).astype(np.float32)
    masks5 = np.zeros((1, 1, 3, 64, 96), np.float32)
    masks5[0, 0, 0, 8:40, 10:50] = 1.0
    masks5[0, 0, 1] = rs.rand(64, 96) > 0.8        # instance 2 stays empty: padded token
    out = _apply(jm, jv, lambda m, z, k: m.decoder.refine_OS8(z, k), jnp.asarray(z),
                 jnp.asarray(masks5))
    with torch.inference_mode():
        logits, feat, tk, _, hidden = tm.decoder.refine_OS8(nchw(z), torch.from_numpy(masks5))
    assert hidden is None and out[4] is None
    assert logits.shape == (1, 10, 8, 12) and logits.dtype == torch.float32
    close(logits.numpy(), out[0], msg="instance logits")
    close(to_nhwc(feat), out[1], msg="smoothed features")
    close(tk.numpy(), out[2], msg="tokens")


# ---------------------------------------------------------------- attention
def _mha_sd(p, prefix=""):
    return {f"{prefix}in_proj_weight": p["in_proj_weight"], f"{prefix}in_proj_bias": p["in_proj_bias"],
            f"{prefix}out_proj.weight": p["out_proj_weight"],
            f"{prefix}out_proj.bias": p["out_proj_bias"]}


def _ln_sd(p, prefix):
    return {f"{prefix}weight": p["ln"]["scale"], f"{prefix}bias": p["ln"]["bias"]}


def _load(mod, sd):
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})


def test_torch_mha_with_all_masked_rows():
    rs = np.random.RandomState(4)
    e, h, L, S, B = 16, 2, 5, 7, 2
    q, k, val = (rs.randn(n, B, e).astype(np.float32) for n in (L, S, S))
    attn_mask = rs.rand(B, L, S) > 0.6
    attn_mask[0, 2] = True                          # every key masked for one query
    kpm = np.zeros((B, S), bool)
    kpm[1, :3] = True
    jmod = jatt.TorchMHA(e, h)
    v = jmod.init(jax.random.PRNGKey(2), *map(jnp.asarray, (q, k, val)))
    v = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.ones_like(a), v)  # non-zero biases
    want = jmod.apply(v, *map(jnp.asarray, (q, k, val)), attn_mask=jnp.asarray(attn_mask),
                      key_padding_mask=jnp.asarray(kpm))
    mod = tatt.TorchMHA(e, h)
    _load(mod, _mha_sd(v["params"]))
    out, att = mod(*map(torch.from_numpy, (q, k, val)), attn_mask=torch.from_numpy(attn_mask),
                   key_padding_mask=torch.from_numpy(kpm))
    assert torch.isfinite(out).all() and float(att[0, 2].detach().abs().sum()) == 0.0
    close(out.detach().numpy(), want[0])
    close(att.detach().numpy(), want[1])


def test_attention_layers():
    rs = np.random.RandomState(5)
    e, L, S, B = 16, 4, 9, 1
    tgt, mem = rs.randn(L, B, e).astype(np.float32), rs.randn(S, B, e).astype(np.float32)
    pos, qpos = rs.randn(S, B, e).astype(np.float32), rs.randn(L, B, e).astype(np.float32)
    kpm = np.array([[False, True, False, True]])
    # self-attention
    jsa = jatt.SelfAttentionLayer(e, 1)
    v = jsa.init(jax.random.PRNGKey(3), jnp.asarray(tgt))
    want = jsa.apply(v, jnp.asarray(tgt), tgt_key_padding_mask=jnp.asarray(kpm),
                     query_pos=jnp.asarray(qpos))
    sa = tatt.SelfAttentionLayer(e, 1)
    _load(sa, {**_mha_sd(v["params"]["self_attn"], "self_attn."),
               **_ln_sd(v["params"]["norm"], "norm.")})
    close(sa(torch.from_numpy(tgt), torch.from_numpy(kpm), torch.from_numpy(qpos))
          .detach().numpy(), want)
    # cross-attention
    jca = jatt.CrossAttentionLayer(e, 1)
    v = jca.init(jax.random.PRNGKey(4), jnp.asarray(tgt), jnp.asarray(mem))
    want = jca.apply(v, jnp.asarray(tgt), jnp.asarray(mem), pos=jnp.asarray(pos),
                     query_pos=jnp.asarray(qpos))
    ca = tatt.CrossAttentionLayer(e, 1)
    _load(ca, {**_mha_sd(v["params"]["multihead_attn"], "multihead_attn."),
               **_ln_sd(v["params"]["norm"], "norm.")})
    got = ca(torch.from_numpy(tgt), torch.from_numpy(mem), pos=torch.from_numpy(pos),
             query_pos=torch.from_numpy(qpos))
    close(got[0].detach().numpy(), want[0])
    close(got[1].detach().numpy(), want[1])
    # FFN
    jff = jatt.FFNLayer(e, 24)
    v = jff.init(jax.random.PRNGKey(5), jnp.asarray(tgt))
    want = jff.apply(v, jnp.asarray(tgt))
    ff = tatt.FFNLayer(e, 24)
    p = v["params"]
    _load(ff, {"linear1.weight": p["linear1"]["kernel"].T, "linear1.bias": p["linear1"]["bias"],
               "linear2.weight": p["linear2"]["kernel"].T, "linear2.bias": p["linear2"]["bias"],
               **_ln_sd(p["norm"], "norm.")})
    close(ff(torch.from_numpy(tgt)).detach().numpy(), want)


# ---------------------------------------------------------------- sparse layers
def test_sparse_layers():
    rs = np.random.RandomState(6)
    x = rs.randn(2, 10, 12, 8).astype(np.float32)
    m1 = (rs.rand(2, 20, 24, 1) > 0.8).astype(np.float32)
    jpyr = jsp.active_pyramid(jnp.asarray(m1))
    tpyr = tsp.active_pyramid(nchw(m1))
    for a, b in zip(tpyr, jpyr):
        np.testing.assert_array_equal(to_nhwc(a), np.asarray(b))
    mc = (rs.rand(2, 10, 12, 1) > 0.4).astype(np.float32)
    mf = np.asarray(jpyr[0])
    # submanifold conv, k3 with bias
    jsub = jsp.SubMConv(6, 3, use_bias=True)
    v = jsub.init(jax.random.PRNGKey(6), jnp.asarray(x), jnp.asarray(mc))
    w = np.array(v["params"]["weight"])
    bias = rs.randn(6).astype(np.float32)
    want = jsub.apply({"params": {"weight": w, "bias": bias}}, jnp.asarray(x), jnp.asarray(mc))
    sub = tsp.SubMConv(8, 6, 3, True)
    _load(sub, {"weight": np.transpose(w, (3, 0, 1, 2)), "bias": bias})
    close(to_nhwc(sub(nchw(x), nchw(mc))), want)
    # inverse conv: coarse (10, 12) -> fine (20, 24)
    jinv = jsp.SparseInverseConv(5)
    v = jinv.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(mc), jnp.asarray(mf))
    want = jinv.apply(v, jnp.asarray(x), jnp.asarray(mc), jnp.asarray(mf))
    inv = tsp.SparseInverseConv(8, 5, 3, False)
    _load(inv, {"weight": np.transpose(np.array(v["params"]["weight"]), (3, 0, 1, 2))})
    got = inv(nchw(x), nchw(mc), nchw(mf))
    assert got.shape == (2, 5, 20, 24)
    close(to_nhwc(got), want)
    # masked batch norm, eval statistics
    jbn = jsp.MaskedBatchNorm()
    v = jbn.init(jax.random.PRNGKey(8), jnp.asarray(x), jnp.asarray(mc))
    stats = {"mean": rs.randn(8).astype(np.float32), "var": rs.rand(8).astype(np.float32) + 0.5}
    prm = {"scale": rs.rand(8).astype(np.float32) + 0.5, "bias": rs.randn(8).astype(np.float32)}
    want = jbn.apply({"params": prm, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(mc))
    bn = tsp.MaskedBatchNorm(8).eval()
    _load(bn, {"weight": prm["scale"], "bias": prm["bias"], "running_mean": stats["mean"],
               "running_var": stats["var"], "num_batches_tracked": np.array(0)})
    close(to_nhwc(bn(nchw(x), nchw(mc))), want)
