"""The port's dense InstMatt ablation decoder (``res_shortcut_inst_matt_22``:
``configs/maggie_image.yaml`` with ``model.decoder`` swapped), its K2 calls,
and the ``ResNetD`` encoder (``res_encoder_29``), against ``maggie_tpu`` on
the CPU, with the same weights (seeded numpy values through ``convert_jax``)
and inputs, at the harness's reduced widths (``test_torch_harness.py``:
attention and final channels 32; the JAX module infers ``layer3``'s input
width, the port takes it from ``final_channel``):

- the eval forward of the MaGGIe harness with this decoder at 2 instances
  on a 128x128 frame: the alphas within 1e-5, ``detail_mask`` and the
  fusion's two bands exactly equal, on JAX's ``compute_unknown`` as the JAX
  tests run it on the CPU (its XLA form); K2 called 3 times;
- one train step against JAX ``make_train_step`` at
  ``test_torch_train.py``'s tolerances, the loss terms at 1e-4 (the
  test's docstring), the fusion's random widths fed the same on both sides
  (``test_torch_mgm.py::same_widths``); K2 called once;
- K2 on bf16 alphas at and next to 1/255 and 254/255: JAX's TPU kernel's
  map (``compute_unknown_pallas`` in interpret mode, which widens to f32);
  under ``--precision 16`` the decoder sends f32 alphas to K2;
- ``ResNetD`` at the module level within 1e-5, and the refusal of both
  harnesses to take it;
- ``convert_jax`` and ``to_jax`` for this decoder, whole and in parts.

Random heads put every alpha inside K2's band, so the os4 and os1 heads'
final convs and the os8 tokens' LayerNorm scale are multiplied by
``HEAD_SCALE`` (``test_torch_mgm.py``'s reason), and the tests assert that
no value K2 reads in the true instances' slots lies within
``test_torch_mgm.MARGIN`` of a threshold.
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.traverse_util import flatten_dict

import maggie_tpu_torch.models.decoder_inst_dense as tdense
import maggie_tpu_torch.models.maggie as tmaggie
from maggie_tpu.engine.optim import build_optimizer as jax_build_optimizer
from maggie_tpu.engine.train_step import TrainState as JaxTrainState
from maggie_tpu.engine.train_step import make_train_step as jax_make_train_step
from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu.models.encoder import ResNetD as JaxResNetD
from maggie_tpu.ops.morphology import compute_unknown as jax_compute_unknown
from maggie_tpu.ops.pallas.unknown import compute_unknown_pallas
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine.optim import build_optimizer
from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.models.encoder import ResNetD
from maggie_tpu_torch.ops.kernels import unknown as ku
from maggie_tpu_torch.utils.convert_jax import _KeyMap, _layout, to_jax
from test_torch_harness import (jax_cfg, jax_step_lock, jax_variables,  # noqa: F401
                                one_torch_thread, port_cfg, port_from_flat, random_flat,
                                shared_shapes)
from test_torch_mgm import (DENSE_SEEDS, MARGIN, blob, global_train_batch, k2_margins,
                            same_widths)
from test_torch_train import (FLAGS, PARAM_ATOL, PARAM_FAR_SHARE, SN_ATOL, STATS_ATOL,
                              _check_grads, _flat, port_step_keeping_grads)
from test_torch_video_train import _keeping_grads

HW = 128
ATOL = 1e-5
HEAD_SCALE = 4.0
TRAIN_HEAD_SCALE = 2.0
TRAIN_LOSS_RTOL = 1e-4    # test_train_step_matches_jax's docstring
LR = 1.5e-4 / 25   # configs/maggie_image.yaml's cosine schedule at update 0
DECODER = "res_shortcut_inst_matt_22"
SCALED = (r"params/decoder_mod/refine_OS[41]/conv2/(weight|bias)",
          r"params/decoder_mod/refine_OS8_mod/decoder_norm/scale")


def dense_cfg():
    jcfg = jax_cfg()
    jcfg.model.decoder = DECODER
    return jcfg


def build_pair(seed: int = 0, head_scale: float = HEAD_SCALE):
    """(JAX config, JAX model, JAX variables, port model, flat)."""
    jcfg = dense_cfg()
    jm = jax_build_model(jcfg.model)
    batch = {"image": jnp.zeros((1, 1, 64, 64, 3)), "mask": jnp.zeros((1, 1, 2, 64, 64))}
    shapes = shared_shapes(f"inst_dense jax_shapes {jm!r}",
                           lambda: jm.init({"params": jax.random.PRNGKey(0)}, batch, train=False))
    flat = random_flat(shapes, seed)
    for k in flat:
        if any(re.fullmatch(p, k) for p in SCALED):
            flat[k] = flat[k] * np.float32(head_scale)
    return jcfg, jm, jax_variables(flat), port_from_flat(port_cfg(jcfg), flat), flat


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def frame(n_i: int = 2, seed: int = 0):
    """(JAX batch, port batch, encoder input NHWC): a noise frame, disc masks."""
    rs = np.random.RandomState(seed)
    img = rs.rand(1, 1, HW, HW, 3).astype(np.float32)
    mask = np.stack([blob(HW, HW, 40 + 45 * j, 50 + 25 * j, 30) > 0.5
                     for j in range(n_i)])[None, None].astype(np.float32)
    slots = np.concatenate([mask[0, 0], np.zeros((10 - n_i, HW, HW), np.float32)])
    inp = np.concatenate([img[0], np.transpose(slots, (1, 2, 0))[None]], axis=-1)
    b = {"image": img, "mask": mask}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()}, inp)


# --------------------------------------------------------------------- eval
def test_eval_forward_matches_jax(pair):
    """The harness's eval forward and the decoder's own result: alphas within
    1e-5, ``detail_mask`` and the bands ``weight_os4``/``weight_os1``
    exactly equal, each band neither empty nor full; K2 three times (k=30
    for ``detail_mask``, then the fusion's k=30 and k=15 in
    ``maggie.prm_fuse``), every input at least ``MARGIN`` from its
    thresholds."""
    _, jm, jv, tm, _ = pair
    jb, tb, inp = frame()

    def jdecoder(m, inp):
        out, mid = m.encoder(inp, train=False)
        return m.decoder(m.aspp(out, train=False), mid, b=1, n_f=1, n_i=2,
                         masks=jnp.transpose(inp[..., 3:], (0, 3, 1, 2)), train=False)
    want, jpred = jax.jit(lambda v, b, x: (jm.apply(v, b, train=False),
                                           jm.apply(v, x, method=jdecoder)))(jv, jb, inp)
    with k2_margins(2, module=tdense) as own, k2_margins(2, module=tmaggie) as fusion:
        got = tm(tb)
    assert len(own) == 1 and len(fusion) == 2, (own, fusion)
    assert min(own + fusion) >= MARGIN, (own, fusion)
    keys = ("alpha_os1", "alpha_os4", "alpha_os8", "refined_masks", "detail_mask")
    assert set(got) == set(keys) and set(want) >= set(keys)
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (1, 1, 2, HW, HW), k
        if k == "detail_mask":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)
    with torch.no_grad():
        out, mid = tm.encoder(torch.from_numpy(inp).permute(0, 3, 1, 2))
        pred = tm.decoder(tm.aspp(out), mid, b=1, n_f=1, n_i=2, masks=mid["image"].new_tensor(
            np.transpose(inp[..., 3:], (0, 3, 1, 2))))
    for k in ("detail_mask", "weight_os4", "weight_os1"):
        np.testing.assert_array_equal(pred[k].numpy(), np.asarray(jpred[k]), err_msg=k)
        assert 0 < float(pred[k].mean()) < 1, k


def test_bf16_alphas_give_the_tpu_kernels_map():
    """K2's wrapper widens bf16 alphas to f32, as the TPU kernel does
    (``maggie_tpu/ops/pallas/unknown.py:100``): at and next to 1/255 and
    254/255 (the bf16 values 2^-8, 2^-8 + 2^-15, 255/256, 127/128) the map
    is the interpret-mode kernel's, in bf16. The choice shows: 1/255 rounds
    up to the bf16 2^-8 + 2^-15, so the JAX package's XLA form, which
    compares in bf16, leaves that value out of the band where the kernel
    (and the port) keep it."""
    rs = np.random.RandomState(0)
    a = (rs.rand(2, 3, 40, 56) > 0.5).astype(np.float32)
    lo = np.float32(1 / 255)
    hi = np.float32(254 / 255)
    near = [np.nextafter(v, d) for v in (2.0 ** -8, 255 / 256) for d in (-1, 1)]
    values = np.array([lo, hi, 2.0 ** -8, 255 / 256, 127 / 128, 2.0 ** -8 + 2.0 ** -15] + near,
                      np.float32)
    ys, xs = rs.randint(0, 40, values.size * 2), rs.randint(0, 56, values.size * 2)
    for i, v in enumerate(np.tile(values, 2)):
        a[i % 2, i % 3, ys[i], xs[i]] = v
    bf = torch.from_numpy(a).to(torch.bfloat16)
    assert set(bf.float().unique().tolist()) == {0.0, 1.0, 2.0 ** -8, 2.0 ** -8 + 2.0 ** -15,
                                                 127 / 128, 255 / 256}
    for k in (30, 15):
        got = ku.compute_unknown(bf, k)
        assert got.dtype == torch.bfloat16
        jbf = jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16)
        want = np.asarray(compute_unknown_pallas(jbf, k_size=k, interpret=True).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=f"k={k}")
        xla = np.asarray(jax_compute_unknown(jbf, k_size=k).astype(jnp.float32))
        assert (xla != want).any()
        assert 0 < float(got.float().mean()) < 1
    with pytest.raises(TypeError, match="float32"):
        ku._launch(bf, 30)


def test_bf16_sends_f32_alphas_to_k2(pair):
    """Under ``--precision 16`` the os8 logits come f32 from the attention's
    product, and the heads' logits are cast to f32 (``:85``), so all three
    K2 calls get f32 alphas, as in the JAX package."""
    jcfg, _, _, _, flat = pair
    cfg = port_cfg(jcfg)
    cfg.precision = "bf16"
    model = port_from_flat(cfg, flat)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        for module in (tdense, tmaggie):
            orig = module.compute_unknown
            mp.setattr(module, "compute_unknown",
                       lambda a, k, orig=orig: seen.append(a.dtype) or orig(a, k))
        out = model(frame()[1])
    assert seen == [torch.float32] * 3
    assert out["refined_masks"].dtype == torch.float32


# ----------------------------------------------------------------- training
def test_train_step_matches_jax():
    """One step at 10 slots (3 instances) on two 128x128 frames (the global
    batch of ``tests/test_torch_baseline_ddp.py``) from identical variables, the fusion's random widths (k=30, then k=15) fed the same:
    every loss term, the gradients before the clip, and the parameters,
    BatchNorm statistics and spectral-norm u/v after the step. K2 runs once
    a step (``detail_mask``), on the os8 alpha of the valid slots.

    The loss terms are held at ``TRAIN_LOSS_RTOL`` 1e-4, not 1e-5: the os4
    alpha is the upsampled head on the attention's train-mode features
    (their BatchNorms see 16x16 sites), and its Sobel term read 4.5e-5 and
    a Laplacian term 1.8e-5 relative apart (the other terms within 5e-6),
    with the heads scaled by ``TRAIN_HEAD_SCALE`` 2 (weight seed 1; at 4,
    4.5e-5 on the same term; unscaled, an os8 alpha lay 6e-8 from a
    threshold)."""
    jcfg, jm, jv, tm, _ = build_pair(seed=1, head_scale=TRAIN_HEAD_SCALE)
    jb, tb = global_train_batch(DENSE_SEEDS)
    widths = [np.random.RandomState(k).randint(1, k, 20) for k in (30, 15)]
    tx = _keeping_grads(jax_build_optimizer(jcfg)[0])
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jv["params"],
                           opt_state=jax.jit(tx.init)(jv["params"]), batch_stats=jv["batch_stats"],
                           spectral=jv["spectral"])
    with same_widths(widths):
        # tests/test_torch_baseline_remat.py holds the remat steps to the same one
        with jax_step_lock("dense"):
            jstate, jld = jax_make_train_step(jm, tx)(jstate, jb, jax.random.PRNGKey(1), **FLAGS)
    tm.train()
    opt, schedule = build_optimizer(ConfigNode(jcfg.to_dict()), tm.parameters())
    state = TrainState(tm, opt)
    with same_widths(widths), k2_margins(3, module=tdense) as margins:
        tld, grads = port_step_keeping_grads(make_train_step(tm, opt, schedule), state, tb,
                                             torch.Generator(), **FLAGS)
    assert len(margins) == 1 and margins[0] >= MARGIN, margins
    check_train_step(jstate, jld, state, tld, grads)


def check_train_step(jstate, jld, state, tld, grads: dict) -> None:
    """A port step (its state after, loss dict and gradients before the
    clip) against JAX's at ``test_train_step_matches_jax``'s limits."""
    keys = tuple(f"loss_{t}{s}" for t in ("rec", "lap", "grad")
                 for s in ("", "_os1", "_os4", "_os8")) + ("loss_max_atten", "total")
    assert set(tld) == set(jld) == set(keys), sorted(set(tld) ^ set(jld))
    rel = {k: abs(float(tld[k]) / float(v) - 1) for k, v in jld.items()}
    assert max(rel.values()) <= TRAIN_LOSS_RTOL, rel
    _check_grads(_flat("params", jstate.opt_state[1]), to_jax(grads))
    assert state.step == int(jstate.step) == 1
    # the whole state_dict at once: its u/v alone do not tell this decoder
    # (and so the embedding encoder) from MGM's (convert_jax._layout)
    got = to_jax(state.model.state_dict())
    want = {**_flat("params", jstate.params), **_flat("batch_stats", jstate.batch_stats),
            **_flat("spectral", jstate.spectral)}
    assert set(got) == set(want)
    d = {k: np.abs(got[k] - w) for k, w in want.items() if k.startswith("params/")}
    assert max(float(v.max()) for v in d.values()) <= 2 * LR + PARAM_ATOL
    far = sum(int((v > PARAM_ATOL).sum()) for v in d.values())
    assert far <= PARAM_FAR_SHARE * sum(v.size for v in d.values()), far
    for coll, tol in (("batch_stats/", STATS_ATOL), ("spectral/", SN_ATOL)):
        worst = max((float(np.abs(got[k] - w).max()), k) for k, w in want.items()
                    if k.startswith(coll))
        assert worst[0] <= tol, worst


# ---------------------------------------------------------------- ResNetD
def test_resnetd_matches_jax_and_no_harness_takes_it():
    """``ResNetD`` alone (RGB | 1 mask, eval mode): the six pyramid maps
    within 1e-5. Both harnesses refuse it: the JAX package's fails to
    unpack its dict at init (ROADMAP.md queue 3), the port's raises a
    ``ValueError`` naming the queue."""
    x = np.random.RandomState(1).rand(1, 64, 64, 4).astype(np.float32)
    jres = JaxResNetD()
    tree = jax.eval_shape(lambda: jres.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    flat = random_flat({"/".join(k): v.shape for k, v in flatten_dict(tree).items()}, 2)
    want = jax.jit(lambda v, x: jres.apply(v, x))(jax_variables(flat), jnp.asarray(x))
    port = ResNetD(4).eval()
    km = _KeyMap()
    km.encoder("enc", "enc", embed=False)
    sd = port.state_dict()
    new = {}
    for tkey, jkey, fn in km.entries:
        t, j = tkey[len("enc."):], jkey.replace("/enc/", "/")
        if t in sd and j in flat and t not in new:
            new[t] = torch.from_numpy(np.ascontiguousarray(
                flat[j] if fn is None else np.transpose(flat[j], fn)))
    assert len(new) == len(flat)
    port.load_state_dict(new, strict=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == {"os1", "os2", "os4", "os8", "os16", "os32"}
    for k, w in want.items():
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=k)
    jcfg = dense_cfg()
    jcfg.model.encoder = "res_encoder_29"
    jm = jax_build_model(jcfg.model)
    batch = {"image": jnp.zeros((1, 1, 64, 64, 3)), "mask": jnp.zeros((1, 1, 2, 64, 64))}
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)}, batch, train=False))
    with pytest.raises(ValueError, match="ROADMAP.md queue 3"):
        build_model(port_cfg(jcfg), device="cpu")


# ----------------------------------------------------------------- weights
def test_convert_jax_leaves_nothing_over(pair):
    """Every JAX array lands in the port and ``to_jax`` gives the tree back;
    the parameters alone and the running statistics alone map as the whole
    does; u/v alone do not tell this decoder from MGM's (``_layout``), and
    map as MGM's, whose encoder has no embedding."""
    _, _, _, tm, flat = pair
    sd = tm.state_dict()
    back = to_jax(sd)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert _layout(sd) == ("inst_dense", True)
    for part in (dict(tm.named_parameters()),
                 {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}):
        got = to_jax(part)
        assert len(got) == len(part) and set(got) <= set(flat)
    uv = [k for k in sd if k.endswith(("weight_u", "weight_v"))]
    assert _layout(uv) == ("dense", False)
