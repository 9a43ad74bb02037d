"""The port's video model (``MaGGIe_Temp``, eval) against ``maggie_tpu`` on the
CPU: the Gaussian smoothing, the ConvGRU, the instance box, the diff module
and the bidirectional fusion, and the whole eval forward over a 3-frame
window, with and without the previous window's alpha and a carried memory;
then the port's feature cache against its own monolithic forward, and the
weight conversion of the video modules both ways.

Sizes are ``tests/test_video_e2e.py::_video_cfg``'s: atten_dim 32,
final_channel 32, max_inst 3, num_mask 3, one attention block, 64x128 frames.
Tolerances: 1e-5 absolute on f32 maps, as ``test_torch_maggie.py`` holds the
image model (the two sides sum convolutions and matmuls in other orders).
The discrete outputs must be equal: ``detail_mask`` (K2's dilation, cut by
the instance box that thresholds a smoothed map at 0.1) and the diff maps
thresholded at 0.5 by the temporal rule. Four thresholds decide a pixel
discretely, and a difference of float rounding at one of them moves an alpha
by up to 1 (a whole row or column of it, for the box): the os8 alpha's snap
to 1 at 0.95, the box's 0.1 on the smoothed os8 alpha (each row's and each
column's largest value decides), the rule's 0.5 on the change maps, and its
exact comparison of the two candidates for frame 1. The inputs are chosen so
that no value lies within ``MARGINS`` of them (``threshold_margins`` records
the distances), and the tests assert it: the port's alphas lie within 2.4e-7
of JAX's, so closer than that, rounding alone could flip a pixel.
"""

import contextlib


import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maggie_tpu.config import load_config
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.models.conv_gru import ConvGRU
from maggie_tpu_torch.ops.smoothing import _gaussian_smoothing_conv, gaussian_smoothing
from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
from maggie_tpu_torch.utils.convert_jax import convert_jax, to_jax
from test_torch_harness import jax_variables, one_torch_thread, port_from_flat, random_flat  # noqa: F401

ATOL = 1e-5
MARGIN = 1e-4
# least distance from each discrete threshold (see the module docstring)
MARGINS = {"snap": 1e-6, "box": 1e-5, "diff": 1e-5, "disagree": 1e-6}
H, W, N_F, N_I = 64, 128, 3, 2
KEYS = ("refined_masks", "alpha_os1", "alpha_os4", "alpha_os8", "temp_alpha",
        "diff_pred_forward", "diff_pred_backward")


def video_cfg():
    """The model subtree of ``tests/test_video_e2e.py::_video_cfg`` (JAX config)."""
    cfg = load_config()
    cfg.model.arch = "MaGGIe_Temp"
    cfg.model.encoder = "res_shortcut_embed_29"
    cfg.model.encoder_args.update(dict(num_embed=3, num_mask=3))
    cfg.model.decoder = "res_shortcut_inst_matt_spconv_temp_22"
    cfg.model.decoder_args.update(dict(
        atten_block=1, atten_dim=32, atten_head=1, atten_stride=1, final_channel=32,
        max_inst=3, use_id_pe=True, sparse_mode="block", block_cap_frac=0.5,
        temp_method="bi_fusion"))
    return cfg


def blob(h, w, cx, cy, r):
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return np.clip((r - d) / max(r * 0.3, 1), 0, 1)


def window(seed, n_f=N_F, h=H, w=W, n_i=N_I):
    """(JAX batch, port batch): noise frames and blob masks that move 3 px a frame."""
    rs = np.random.RandomState(seed)
    img = rs.rand(1, n_f, h, w, 3).astype(np.float32)
    mask = np.stack([[blob(h, w, 30 + 50 * j + 3 * t + seed, 32, 20) > 0.5 for j in range(n_i)]
                     for t in range(n_f)])[None].astype(np.float32)
    jb = {"image": img, "mask": mask}
    return jb, {k: torch.from_numpy(v) for k, v in jb.items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model, flat, jitted JAX eval forward).
    The variable tree's keys and shapes come from the port's model through
    ``to_jax``, in sorted order; JAX's apply raises on any it lacks, and
    ``test_convert_jax_round_trip_and_sn_fold`` counts the video ones."""
    cfg = video_cfg()
    port_cfg = ConfigNode(cfg.model.to_dict())
    shapes = {k: v.shape for k, v in to_jax(build_model(port_cfg, device="cpu")
                                            .state_dict()).items()}
    # weight seed 10: about a quarter of each window is uncertain, and the diff
    # maps lie on both sides of 0.5, every value the rule reads at least
    # 2.7e-4 away (with most seeds the whole map is uncertain or a threshold
    # is within MARGINS)
    flat = random_flat(dict(sorted(shapes.items())), seed=10)
    jm = jax_build_model(cfg.model)
    fwd = jax.jit(lambda v, b, pp, mf: jm.apply(v, b, train=False, prev_pred=pp, mem_feat=mf))
    return jm, jax_variables(flat), port_from_flat(port_cfg, flat), flat, fwd


@contextlib.contextmanager
def threshold_margins():
    """Record, for every window the port's video model decodes, how far its
    values lie from the four discrete thresholds: the os8 alpha (as K2's k=30
    call gets it, before the snap) from 0.95; each row's and each column's
    largest smoothed os8 alpha from the box's 0.1; the change maps the rule
    reads from 0.5; and the rule's two frame-1 candidates from each other,
    except where their equality holds whatever the rounding (both are frame
    1 itself, or both are 0 or 1). Yields {name: [distance per window]}."""
    import maggie_tpu_torch.models.decoder_video as dv
    from maggie_tpu_torch.models.maggie_temp import MaGGIeTemp
    rec = {k: [] for k in MARGINS}
    unknown, box, finalize = (dv.compute_unknown, dv.ResShortCutInstMattSpconvTempDec._bbox_mask,
                              MaGGIeTemp._finalize_eval)

    def spy_unknown(x, k_size):
        if k_size == 30:
            rec["snap"].append(float((x - 0.95).abs().min()))
        return unknown(x, k_size)

    def spy_box(x):
        sm = gaussian_smoothing(x, 3)
        rec["box"].append(min(float((sm.amax(dim=a) - 0.1).abs().min()) for a in (-1, -2)))
        return box(x)

    def spy_finalize(self, out, prev_pred):
        a, f, b = out["refined_masks"], out["diff_pred_forward"], out["diff_pred_backward"]
        rec["diff"].append(min(float((f[:, 1:] - 0.5).abs().min()),
                               float((b[:, :-1] - 0.5).abs().min())))
        pp = a[:, 0] if prev_pred is None else prev_pred
        df, db = f[:, 1] > 0.5, b[:, 1] > 0.5
        f01, b21 = torch.where(df, a[:, 1], pp), torch.where(db, a[:, 1], a[:, -1])
        # robust equalities: both candidates frame 1 itself, or equal at 0 or 1
        robust = (df & db) | ((f01 == b21) & ((f01 == 0) | (f01 == 1)))
        d = (f01 - b21).abs()[~robust]
        rec["disagree"].append(float(d.min()) if d.numel() else 1.0)
        return finalize(self, out, prev_pred)

    dv.compute_unknown = spy_unknown
    dv.ResShortCutInstMattSpconvTempDec._bbox_mask = staticmethod(spy_box)
    MaGGIeTemp._finalize_eval = spy_finalize
    try:
        yield rec
    finally:
        dv.compute_unknown = unknown
        dv.ResShortCutInstMattSpconvTempDec._bbox_mask = staticmethod(box)
        MaGGIeTemp._finalize_eval = finalize


def assert_margins(rec, windows):
    """Every recorded window keeps ``MARGINS`` from each threshold."""
    for k, limit in MARGINS.items():
        assert len(rec[k]) == windows, (k, rec[k])
        assert min(rec[k]) > limit, (k, rec[k])


def _apply(jm, jv, fn, *args):
    return jax.device_get(jax.jit(lambda v, *a: jm.apply(v, *a, method=fn))(jv, *args))


def close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("shape", [(2, 3, 40, 56), (1, 2, 6, 9)])
def test_gaussian_smoothing(shape):
    """The matrix form on maps larger than 2*pad, the literal conv form on
    smaller ones; and the matrix form equals the literal chain (over-crop and
    resize back included)."""
    from maggie_tpu.ops import smoothing as js
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    got = gaussian_smoothing(torch.from_numpy(x), 3).numpy()
    close(got, np.asarray(js.gaussian_smoothing(jnp.asarray(x), 3)))
    close(got, _gaussian_smoothing_conv(torch.from_numpy(x), 3).numpy())


def test_gaussian_smoothing_matrices_made_once_per_device():
    """The matrix form's matrices are made on the map's device once per
    shape: a later call reuses them, and they serve a call with autograd
    after one in inference mode."""
    from maggie_tpu_torch.ops.smoothing import _device_matrices
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 3, 37, 51).astype(np.float32))
    _device_matrices.cache_clear()
    with torch.inference_mode():
        first = gaussian_smoothing(x, 3)
    y = x.clone().requires_grad_()
    again = gaussian_smoothing(y, 3)
    again.sum().backward()
    assert _device_matrices.cache_info().misses == 1
    assert _device_matrices.cache_info().hits == 1
    assert torch.equal(first, again.detach())
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())


@pytest.mark.parametrize("method", ["none", "forward", "bi"])
def test_conv_gru(method):
    """``propagate_features`` over 3 frames, outputs and hidden state, from a
    zero state and from a given one."""
    from maggie_tpu.models.conv_gru import ConvGRU as JaxGRU
    c, rs = 8, np.random.RandomState(2)
    feat = rs.randn(1, N_F, 6, 10, c).astype(np.float32)
    h0 = rs.randn(1, 6, 10, c).astype(np.float32) * 0.5
    jg = JaxGRU(c)
    params = jg.init(jax.random.PRNGKey(0), jnp.asarray(feat))["params"]
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(rs.randn(*p.shape) * 0.2, jnp.float32),
                                    params)
    tg = ConvGRU(c)
    sd = {}
    for name, t in (("ih_conv", "ih.0"), ("hh_conv", "hh.0")):
        sd[f"{t}.weight"] = torch.from_numpy(np.transpose(np.asarray(params[name]["weight"]),
                                                          (3, 2, 0, 1)).copy())
        sd[f"{t}.bias"] = torch.from_numpy(np.array(params[name]["bias"]))
    tg.load_state_dict(sd)
    for prev in (None, h0):
        jf, jh = jg.apply({"params": params}, jnp.asarray(feat), feat.shape[1],
                          None if prev is None else jnp.asarray(prev), method,
                          method=JaxGRU.propagate_features)
        with torch.no_grad():
            tf, th = tg.propagate_features(
                torch.from_numpy(feat).permute(0, 1, 4, 2, 3),
                None if prev is None else torch.from_numpy(prev).permute(0, 3, 1, 2), method)
        close(tf.permute(0, 1, 3, 4, 2).numpy(), jf, f"{method} features")
        perm = (0, 2, 3, 1) if th.dim() == 4 else (0, 1, 3, 4, 2)
        close(th.permute(*perm).numpy(), jh, f"{method} hidden")


def test_bbox_mask(pair):
    """The instance box of soft blobs, an empty map (all ones) and a map at
    the border, equal to JAX's. The box is decided by each row's and each
    column's largest smoothed value against 0.1: none lies within MARGIN."""
    jm, jv, tm, _, _ = pair
    x = np.zeros((2, 2, H, W), np.float32)
    x[0, 0] = blob(H, W, 40, 30, 12)
    x[0, 1] = blob(H, W, 120, 5, 10) * 0.8
    x[1, 0] = blob(H, W, 70, 40, 20)
    smooth = gaussian_smoothing(torch.from_numpy(x), 3).numpy()
    assert min(np.abs(smooth.max(axis=a) - 0.1).min() for a in (-1, -2)) > MARGIN
    want = _apply(jm, jv, lambda m, a: m.decoder._bbox_mask(a, 2), jnp.asarray(x))
    got = tm.decoder._bbox_mask(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1, 1].all() and not got[0, 0].all()


def test_diff_module_and_fusion(pair):
    """The diff module on two frames' features and ``bidirectional_fusion``
    over a 3-frame window (logit maps and fused alphas)."""
    jm, jv, tm, _, _ = pair
    rs = np.random.RandomState(5)
    feat = rs.randn(1, N_F, 8, 16, 32).astype(np.float32)
    preds = rs.rand(1, N_F, N_I, H, W).astype(np.float32)
    pair_feat = np.concatenate([feat[:, 0], feat[:, 1]], axis=-1)
    want = _apply(jm, jv, lambda m, f: m.decoder.diff_module(f), jnp.asarray(pair_feat))
    with torch.inference_mode():
        got = tm.decoder.diff_module(torch.from_numpy(pair_feat).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1).numpy(), want, "diff module")
    want = _apply(jm, jv, lambda m, f, p: m.decoder.bidirectional_fusion(f, p, False, False),
                  jnp.asarray(feat), jnp.asarray(preds))
    with torch.inference_mode():
        got = tm.decoder.bidirectional_fusion(torch.from_numpy(feat).permute(0, 1, 4, 2, 3),
                                              torch.from_numpy(preds))
    for g, w_, name in zip(got, want, ("diff_forward", "diff_backward", "fused")):
        close(g.numpy(), w_, name)


def _eval_pair(pair, jb, tb, pp=None, mf=None):
    jm, jv, tm, _, fwd = pair
    jout = jax.device_get(fwd(jv, jb, None if pp is None else jnp.asarray(pp),
                              None if mf is None else jnp.asarray(mf)))
    with torch.inference_mode():
        tout = tm(tb, prev_pred=None if pp is None else torch.from_numpy(pp),
                  mem_feat=None if mf is None else torch.from_numpy(mf).permute(0, 3, 1, 2))
    return jout, tout


def _assert_eval_equal(jout, tout, label):
    assert set(tout) == set(KEYS) | {"detail_mask", "mem_feat"}, label
    for k in ("diff_pred_forward", "diff_pred_backward"):
        np.testing.assert_array_equal(tout[k].numpy() > 0.5, np.asarray(jout[k]) > 0.5,
                                      err_msg=f"{label} {k}")
    np.testing.assert_array_equal(tout["detail_mask"].numpy(), np.asarray(jout["detail_mask"]),
                                  err_msg=label)
    for k in KEYS:
        assert tuple(tout[k].shape) == (1, N_F, N_I, H, W), (label, k)
        close(tout[k].numpy(), jout[k], f"{label} {k}")
    mem = tout["mem_feat"].permute(0, 1, 3, 4, 2).numpy()
    close(mem, jout["mem_feat"], f"{label} mem_feat")


def test_eval_forward_matches_maggie_tpu(pair):
    """A fresh window, then the next window with the first one's frame-1
    alpha as ``prev_pred`` and its frame-0 hidden state as ``mem_feat`` (the
    engine's ``carry_memory``)."""
    jb, tb = window(0)
    with threshold_margins() as rec:
        jout, tout = _eval_pair(pair, jb, tb)
        pp = np.asarray(jout["refined_masks"])[:, 1]
        mf = np.asarray(jout["mem_feat"])[:, 0]
        jb, tb = window(1)
        jout2, tout2 = _eval_pair(pair, jb, tb, pp, mf)
    assert_margins(rec, 2)
    _assert_eval_equal(jout, tout, "fresh")
    assert 0.02 < float(tout["detail_mask"].mean()) < 0.9
    _assert_eval_equal(jout2, tout2, "carried")
    # the carried state changes the window: the test reaches both inputs
    _, fresh = _eval_pair(pair, jb, tb)
    assert not torch.equal(fresh["refined_masks"], tout2["refined_masks"])
    assert not torch.equal(fresh["alpha_os8"], tout2["alpha_os8"])


def test_cached_window_equals_the_monolithic_forward(pair):
    """``encode_frames`` on the new frame, the pack rolled by one frame, then
    ``decode_window``: bit for bit the forward on the whole window."""
    _, _, tm, _, _ = pair
    _, tb = window(2, n_f=4)
    with torch.inference_mode():
        first = tm.encode_frames({k: v[:, :3] for k, v in tb.items()})
        out0 = tm.decode_window(first)
        new = tm.encode_frames({k: v[:, 3:] for k, v in tb.items()})
        rolled = {k: torch.cat([first[k][1:], new[k]]) for k in first}
        pp = out0["refined_masks"][:, 1]
        cached = tm.decode_window(rolled, prev_pred=pp)
        mono = tm({k: v[:, 1:] for k, v in tb.items()}, prev_pred=pp)
        mono0 = tm({k: v[:, :3] for k, v in tb.items()})
    assert "inp" in first and "fea1" not in first       # the lazy os1 input is cached
    assert set(cached) == set(mono)
    for k in mono:
        assert torch.equal(cached[k], mono[k]), k
        assert torch.equal(out0[k], mono0[k]), k


def test_convert_jax_round_trip_and_sn_fold(pair):
    """Every video-module array reaches the port under the reference's names
    and comes back by ``to_jax``; the folded diff module (both SN convs in the
    conv layout) gives the unfolded one's output."""
    jm, jv, tm, flat, _ = pair
    sd = tm.state_dict()
    video = {k: v for k, v in flat.items() if "os8_temp_module" in k or "diff_module" in k}
    assert len(video) == 20
    for name in ("decoder.os8_temp_module.ih.0.weight", "decoder.os8_temp_module.hh.0.bias",
                 "decoder.diff_module.0.module.weight_u", "decoder.diff_module.3.module.weight_v",
                 "decoder.diff_module.1.running_var", "decoder.diff_module.6.weight"):
        assert name in sd, name
    back = to_jax(sd)
    for k, v in video.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert set(convert_jax(back, tm)) == set(sd)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 64, 8, 16).astype(np.float32))
    folded = port_from_flat(ConfigNode(video_cfg().model.to_dict()), flat)
    fold_spectral_norm(folded)
    assert not hasattr(folded.decoder.diff_module[0].module, "weight_u")
    with torch.inference_mode():
        want = tm.decoder.diff_module(x)
        got = folded.decoder.diff_module(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    for i in (0, 3):
        m = tm.decoder.diff_module[i]
        with torch.no_grad():
            want = (m.module.weight_bar / m.sigma()).numpy()
            np.testing.assert_allclose(folded.decoder.diff_module[i].module.weight_bar.numpy(),
                                       want, rtol=1e-6, atol=1e-7)
