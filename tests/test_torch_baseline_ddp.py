"""Data parallelism of the baselines' train steps on the CPU: two gloo ranks
(``tests/torch_ddp_worker.py``, spawned once for every case, as
``tests/test_torch_ddp.py`` spawns them, with its timeouts and limits)
against one process on the global batch and against the JAX package's
single-device step:

- ``configs/mgm_tcvom.yaml`` (``TCVOM_SingInst`` at one slot) on two clips
  of ``test_torch_tcvom.CLIP`` frames at 128x128, a clip a rank: the FAM's
  bands, and with them the attention loss's counts, differ between the
  ranks;
- ``configs/sparsemat_image.yaml`` on two 128x128 images, an image a rank,
  the second image's active set emptied (on both sides of each comparison),
  so that rank 1 holds no active site in any masked BatchNorm;
- the dense InstMatt decoder on two 128x128 frames at 10 slots (3
  instances each), a frame a rank, plain and under ``model.remat selective``: the selective world-2
  step is bit-equal to the plain world-2 step on every rank.

Each world-2 step is held against one process at ``test_torch_ddp.py``'s
limits (``compare_to_single``; its docstring gives their reasons), the ranks
bit-equal after the update, and against JAX ``make_train_step`` on the
global batch at the family's train-step tolerances (the helpers of
``test_torch_mgm.py``, ``test_torch_sparsemat.py`` and
``test_torch_inst_dense.py``), the fusion's widths fed the same.

And a fault the port had: TCVOM's attention loss divided each rank's band
sum by the rank's own band count, so the ranks' parts did not add up to
the global loss (ROADMAP.md queue 3). ``test_world2_attention_loss_equals_one_process``
holds the loss and its logits' gradients at world 2, with ranks whose band
counts differ (one rank's 0 in a frame), to one process's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import maggie_tpu_torch.models.decoder_inst_dense as tdense
import test_torch_inst_dense as tid
import test_torch_mgm as tmgm
import test_torch_sparsemat as tsm
import torch_ddp_worker as worker
from maggie_tpu.models.sparsemat import SparseMat as JaxSparseMat
from test_torch_baseline_remat import _widths, jax_step
from test_torch_ddp import (FLAGS, NORM_ATOL, TIMEOUT_S, assert_ranks_equal,
                            compare_to_single, start_ranks, summed_losses)
from test_torch_harness import one_torch_thread  # noqa: F401
from test_torch_tcvom import CLIP

EMPTY_ROWS = [1]      # sparsemat_image: the second image (rank 1's) has no active site
# sparsemat_image's size: at 128x128 the LPN's last stages see 2x2 sites and
# its step is ill-conditioned (test_torch_sparsemat.py): a gradient tensor of
# the world-2 step read 7.5% from one process's, beyond the per-tensor 5e-2
SM_HW = 256
# its batch's seed: the low-resolution alphas lie 2.1e-6 or more from 0.01 and
# 0.99 (seeds 0-4 and 6-7 came within 1.1e-6; test_torch_sparsemat.MARGIN 1e-6)
SM_SEED = 5


def _case(name: str) -> SimpleNamespace:
    """The config's JAX model and variables, the global batch (numpy), the
    port payload for the worker's ``run_step``, and the family's check."""
    if name == "mgm_tcvom":
        jcfg, jm, jv, tm, _ = tmgm.build_pair(name, head_scale=tmgm.TRAIN_HEAD_SCALE)
        batch = {k: v.numpy() for k, v in tmgm.global_train_batch(
            tmgm.TCVOM_SEEDS, n_f=CLIP, slots=1, n_i=1)[1].items()}
        keys = (tmgm.LOSS_KEYS + tuple(f"loss_dtSSD{s}" for s in ("", "_os1", "_os4", "_os8"))
                + ("loss_atten", "total"))
        check = lambda js, jld, st, tld, g: tmgm.check_step(js, jld, st, tld, g, keys)
        widths, modes = _widths(2 * CLIP), ("none",)
    elif name == "sparsemat_image":
        jcfg, jm, jv, tm, _ = tsm.build_pair()
        batch = {k: np.asarray(v) for k, v in tsm.train_batch(hw=SM_HW, seed=SM_SEED)[0].items()}
        check, widths, modes = tsm.check_train_step, None, ("none",)
    else:
        jcfg, jm, jv, tm, _ = tid.build_pair(seed=1, head_scale=tid.TRAIN_HEAD_SCALE)
        batch = {k: v.numpy() for k, v in tmgm.global_train_batch(tmgm.DENSE_SEEDS)[1].items()}
        check, widths, modes = tid.check_train_step, _widths(2 * 10), ("none", "selective")
    # the worker takes the widths by call: the k=30 dilation's, then k=15's
    payload = dict(cfg=jcfg.to_dict(), state=tm.state_dict(), modes=list(modes), flags=FLAGS,
                   seed=5, widths=None if widths is None else [widths[30], widths[15]],
                   empty_rows=EMPTY_ROWS if name == "sparsemat_image" else None,
                   batch={k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    return SimpleNamespace(name=name, jcfg=jcfg, jm=jm, jv=jv, batch=batch, payload=payload,
                           check=check, widths=widths,
                           jb={k: jnp.asarray(v) for k, v in batch.items()})


def atten_payload() -> dict:
    """TCVOM's attention-loss inputs for 4 clips of 4 frames at 64x64 (2 a
    rank): GT alphas, logits, and bands at os8 whose counts differ between
    the ranks, rank 1's 0 in frame 1 (one process's count is then rank 0's)."""
    rs = np.random.RandomState(4)
    b, n_f, hw = 4, 4, 64
    sites = (hw // 8) ** 2
    alphas = rs.rand(b, n_f, 1, hw, hw).astype(np.float32)
    band = lambda share: (rs.rand(b, 1, hw // 8, hw // 8) < share).astype(np.float32)
    mask1 = band(0.4)
    mask1[2:] = 0
    masks = [None, mask1, band(np.array([0.7, 0.6, 0.2, 0.1])[:, None, None, None]), None]
    logits = lambda: [None] + [rs.randn(b, 81, sites).astype(np.float32) * 2
                               for _ in range(n_f - 2)] + [None]
    t = lambda a: None if a is None else torch.from_numpy(a)
    return {"alphas": t(alphas), "attb": [t(a) for a in logits()],
            "attf": [t(a) for a in logits()], "small_mask": [t(m) for m in masks]}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every case on one pair of ranks (one spawn), and, while the ranks
    run, its single-process runs and JAX's step on the global batch
    (``global_jax_step``) in this process: {name: (case, ranks' results,
    one process's)}; each case's JAX step in ``case.jax``."""
    cases = {name: _case(name) for name in ("mgm_tcvom", "sparsemat_image", "dense")}
    atten = atten_payload()
    p = {"cases": {"atten": ("atten", atten),
                   **{name: ("step", c.payload) for name, c in cases.items()}}}
    wait = start_ranks("cases", p, tmp_path_factory.mktemp("ddp_baselines"),
                       timeout=TIMEOUT_S * len(p["cases"]))
    singles = {"atten": worker.run_atten(atten)}
    for name, c in cases.items():
        if name == "sparsemat_image":
            with tsm.Margins() as rec:
                single = worker.run_step(c.payload)
            assert min(rec.alpha) >= tsm.MARGIN and rec.active[0] > 0.1, (rec.alpha, rec.active)
        elif name == "dense":
            with tmgm.k2_margins(3, module=tdense) as margins:
                single = worker.run_step(dict(c.payload, modes=["none"]))
            assert min(margins) >= tmgm.MARGIN, margins
        else:
            single = worker.run_step(c.payload)
        singles[name] = single
        c.jax = global_jax_step(c)
    ranks = wait()
    out = {"atten": ([r["atten"] for r in ranks], singles["atten"])}
    for name, c in cases.items():
        out[name] = (c, [r[name] for r in ranks], singles[name])
    return out


def test_world2_attention_loss_equals_one_process(world2):
    """TCVOM's ``compute_atten_loss`` on two ranks against one process on the
    concatenated clips: the ranks' parts of the loss sum to its loss, and
    each row's logit gradients equal its own, within ``NORM_ATOL``. Rank 1
    holds no band site in frame 1 and the ranks' counts differ in frame 2;
    the loss divides by the global count."""
    ranks, single = world2["atten"]
    counts = [r["band_count"] for r in ranks]
    assert counts[1][1] == 0 < counts[0][1] and counts[0][2] != counts[1][2] > 0, counts
    got = sum(float(r["loss"]) for r in ranks)
    assert abs(got - float(single["loss"])) <= NORM_ATOL * abs(float(single["loss"])), (
        got, float(single["loss"]))
    for key in ("attb_grad", "attf_grad"):
        for c in (1, 2):
            cat = torch.cat([r[key][c] for r in ranks])
            np.testing.assert_allclose(cat.numpy(), single[key][c].numpy(), rtol=0,
                                       atol=NORM_ATOL * float(single[key][c].abs().max()),
                                       err_msg=f"{key} frame {c}")


@pytest.mark.parametrize("name", ["mgm_tcvom", "sparsemat_image", "dense"])
def test_world2_step_equals_one_process(world2, name):
    """The world-2 step against one process on the global batch at
    ``test_torch_ddp.py``'s limits: loss terms (the ranks' parts summed),
    gradients, parameters, statistics, u/v, the generator; the ranks
    bit-equal after the update."""
    c, ranks, single = world2[name]
    assert_ranks_equal(ranks)
    if name == "mgm_tcvom":
        assert single["none"]["losses"]["loss_atten"] > 0
    if name == "sparsemat_image":
        ranks, single = _without_cancelled(c, ranks, single)
    print(name, "world 2 vs one process:", compare_to_single(ranks, single))


def _without_cancelled(c, ranks: list, single: dict):
    """The LPN's conv biases that feed an ``IBNorm`` have a gradient of 0:
    both halves of the norm subtract the bias's mean again. What a step
    computes for them is what is left of cancelling f32 sums, at 1e-8 to
    5e-8 of the largest gradient, and another order of the sums (world 2)
    gives other leftovers: 5.8% of ``compare_to_single``'s per-tensor floor
    of 1e-6 of the largest gradient, at 256x256 (7.5% at 128x128). Those
    tensors are held below 1e-6 of the largest gradient on both sides, and
    left out of the per-tensor comparison; every other part of it stands
    (their parameters too, within 2 lr + 1e-6)."""
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.models.lpn import ConvIBNRelu
    model = build_model(ConfigNode(c.payload["cfg"]).model, device="cpu")
    cancelled = {f"{n}.conv.bias" for n, m in model.named_modules()
                 if isinstance(m, ConvIBNRelu) and m.ibn is not None}
    assert len(cancelled) == 10
    l2 = lambda t: float((t.double() ** 2).sum()) ** 0.5
    for res in [r["none"] for r in ranks] + [single["none"]]:
        top = max(l2(g) for g in res["grads"].values())
        assert max(l2(res["grads"][k]) for k in cancelled) <= 1e-6 * top
    keep = lambda res: {**res, "grads": {k: g for k, g in res["grads"].items()
                                         if k not in cancelled}}
    return [{"none": keep(r["none"])} for r in ranks], {"none": keep(single["none"])}


def test_world2_selective_equals_world2_plain(world2):
    """The dense InstMatt decoder's world-2 step under ``model.remat
    selective`` (its recompute issues the BatchNorms' all-reduces again, on
    both ranks in the same order) bit-equal to the plain world-2 step on
    every rank: loss terms, gradients, the model after the update, the
    generator."""
    _, ranks, _ = world2["dense"]
    assert_ranks_equal(ranks, "selective")
    for r in ranks:
        plain, sel = r["none"], r["selective"]
        assert sel["losses"] == plain["losses"]
        assert sel["digest"] == plain["digest"]
        assert torch.equal(sel["generator"], plain["generator"])
        for k, g in plain["grads"].items():
            assert torch.equal(sel["grads"][k], g), k


def global_jax_step(c):
    """``jax_step`` on the global batch, SparseMat's emptied rows emptied:
    (state after, loss dict). ``mgm_tcvom``'s and the dense decoder's are the
    steps their family files and ``test_torch_baseline_remat.py`` compute
    (``test_torch_mgm.global_train_batch``), under the same lock."""
    with pytest.MonkeyPatch.context() as mp:
        if c.name == "sparsemat_image":
            dilate = JaxSparseMat.dilate
            keep = np.ones((c.batch["image"].shape[0], 1, 1, 1), np.float32)
            keep[EMPTY_ROWS] = 0
            mp.setattr(JaxSparseMat, "dilate", lambda self, a: dilate(self, a) * keep)
            return jax_step(c)
        return jax_step(c, lock=c.name)


@pytest.mark.parametrize("name", ["mgm_tcvom", "sparsemat_image", "dense"])
def test_world2_step_matches_jax(world2, name):
    """The world-2 step (the ranks' loss parts summed, the gradients the clip
    received, the state after) against JAX's single-device step on the
    global batch, at the family's train-step tolerances."""
    c, ranks, _ = world2[name]
    jstate, jld = c.jax
    got = ranks[0]["none"]
    state = SimpleNamespace(step=1, params=lambda: got["params"],
                            batch_stats=lambda: got["batch_stats"],
                            spectral=lambda: got["spectral"],
                            model=SimpleNamespace(state_dict=lambda: got["state_dict"]))
    c.check(jstate, jld, state, summed_losses(ranks), got["grads"])
