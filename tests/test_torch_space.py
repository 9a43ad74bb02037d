"""Row sharding of the port's flagship train step (``maggie_tpu_torch/parallel/space.py``)
at ``data 2 x space 2`` on the CPU, and its refusals.

The ``2 x 2`` step is ``maggie_tpu_torch.dryrun.dryrun_multichip(4,
device="cpu")`` itself: four gloo ranks (one spawn, each with a timeout on
its group and on ``communicate``), one frame of 128 x 128 a data shard,
each frame's rows split over a space group of two, against one process on
the whole batch, which the entry holds to the JAX entry's limits before it
returns the ranks' records; here they are held to
``tests/test_torch_ddp.py``'s tighter STEP limits, with every rank
bit-equal. The ``1 x 2`` cases (each banded module, the step against one
process and against JAX, the ladder over its capacity) run in
``tests/test_torch_ddp.py``'s rank pair.
"""

import numpy as np
import pytest
import torch

from test_torch_ddp import _torchrun_env, compare_to_single
from test_torch_harness import one_torch_thread  # noqa: F401
from maggie_tpu_torch import dryrun, parallel
from maggie_tpu_torch.config import ConfigNode
from maggie_tpu_torch.engine import train_step as ts
from maggie_tpu_torch.models import build_model
from maggie_tpu_torch.ops.resize import resize_bilinear
from maggie_tpu_torch.parallel import space


@pytest.fixture(scope="module")
def dryrun_2x2():
    """``dryrun_multichip(4, device="cpu")``: data 2 x space 2."""
    return dryrun.dryrun_multichip(4, device="cpu")


def test_dryrun_2x2_equals_one_process(dryrun_2x2):
    """The 2 x 2 step against one process on the whole batch at the STEP
    limits (loss terms summed over the ranks, gradients as the optimizer
    applies them, parameters, statistics, u/v), every rank bit-equal
    (model, gradients, generator)."""
    ranks, single = dryrun_2x2["ranks"], dryrun_2x2["single"]
    assert dryrun_2x2["mesh"] == (2, 2) and dryrun_2x2["hw"] == 128
    for r in ranks[1:]:
        assert r["digest"] == ranks[0]["digest"]
        assert torch.equal(r["generator"], ranks[0]["generator"])
        for k, g in ranks[0]["grads"].items():
            assert torch.equal(r["grads"][k], g), k
    print("2 x 2 vs one process:", compare_to_single([{"none": r} for r in ranks],
                                                     {"none": single}))


def test_dryrun_2x2_replicated_terms_count_once(dryrun_2x2):
    """The attention loss, computed on the replicated os8 stage by both
    space ranks of a data shard, enters the total on space rank 0 only (the
    other copy weighs 0); the banded terms are every rank's part. (The
    entry's alphas are positive everywhere, so the GT masks cover the frame
    and the attention loss itself is 0 up to rounding; the 1 x 2 steps of
    ``tests/test_torch_ddp.py`` hold a loss of about 2 summed over the ranks
    to one process's.)"""
    ranks = dryrun_2x2["ranks"]
    for r, rec in enumerate(ranks):
        if r % 2:
            assert rec["losses"]["loss_max_atten"] == 0.0, (r, rec["losses"])
        assert rec["losses"]["loss_rec_os1"] != 0.0


def _batch(h=128, w=64, b=4):
    return dryrun.make_batch(b, 1, 2, h, w, with_gt=True)


def test_shard_batch_2d_takes_the_shard_then_the_band():
    """Rank (d, s) of data 2 x space 2 holds data shard d's frames and band
    s of their rows: H for image, alpha and transition, H/8 for the masks."""
    batch = _batch()
    for rank in range(4):
        d, s = divmod(rank, 2)
        part = space.shard_batch_2d(batch, rank, 4, 2)
        assert torch.equal(part["image"], batch["image"][2 * d:2 * d + 2, :, 64 * s:64 * s + 64])
        assert torch.equal(part["mask"], batch["mask"][2 * d:2 * d + 2, :, :, 8 * s:8 * s + 8])
        for k in ("alpha", "transition"):
            assert torch.equal(part[k], batch[k][2 * d:2 * d + 2, :, :, 64 * s:64 * s + 64])


@pytest.mark.parametrize("h", [96, 192])
def test_frame_that_does_not_split_raises(h):
    """A frame whose rows are not two bands of whole 64-row blocks raises a
    ValueError naming its rows and the multiple they need."""
    with pytest.raises(ValueError, match=f"{h} rows .* multiple of 128"):
        space.shard_batch_2d(_batch(h=h), 0, 2, 2)


def _reduced(**decoder):
    cfg = dryrun.image_model_cfg(atten_dim=32, final_channel=32)
    cfg.model.decoder_args.update(decoder)
    return ConfigNode(cfg.to_dict())


def test_unsharded_archs_and_modes_raise(monkeypatch):
    """Under row sharding (space 2; the check runs before any collective),
    what is not yet sharded raises a ValueError naming it: another arch,
    the dense oracle ladder, ``model.remat full`` and ``selective``, and
    eval."""
    monkeypatch.setattr(parallel.dist, "_space", 2)
    gen = torch.Generator()
    dummy = build_model(ConfigNode({"arch": "Dummy"}), device="cpu").train()
    with pytest.raises(ValueError, match="arch Dummy is not yet sharded"):
        ts.compute_grads(dummy, _batch(), gen)
    flagship = build_model(_reduced().model, device="cpu").train()
    for mode in ("full", "selective"):
        with pytest.raises(ValueError, match=f"model.remat {mode} is not yet sharded"):
            ts.compute_grads(flagship, _batch(), gen, remat=mode)
    oracle = build_model(_reduced(sparse_mode="oracle").model, device="cpu").train()
    with pytest.raises(ValueError, match="'oracle' ladder is not yet sharded"):
        ts.compute_grads(oracle, _batch(), gen)
    with pytest.raises(ValueError, match="eval is not yet sharded"):
        flagship.eval()(_batch())


def test_space_1_is_the_data_parallel_path(monkeypatch):
    """``space.init_groups(1)`` in a group of one rank runs the step that no
    group runs, bit for bit (loss terms, gradients, the model after, the
    generator); a space that does not divide the world raises."""
    cfg = _reduced()
    state = dryrun._model(cfg, "cpu").state_dict()
    batch = dryrun.make_batch(1, 1, 2, 64, 64, with_gt=True)
    alone = dryrun.run_step(cfg, state, batch, torch.device("cpu"))
    _torchrun_env(monkeypatch)
    parallel.init_from_env(device="cpu")
    try:
        with pytest.raises(ValueError, match="space 2 does not divide the world of 1"):
            space.init_groups(2)
        space.init_groups(1)
        assert parallel.space_world() == 1 and parallel.data_world() == 1
        grouped = dryrun.run_step(cfg, state, batch, torch.device("cpu"))
    finally:
        parallel.destroy()
    assert grouped["losses"] == alone["losses"] and grouped["digest"] == alone["digest"]
    assert torch.equal(grouped["generator"], alone["generator"])
    for k, g in alone["grads"].items():
        assert torch.equal(grouped["grads"][k], g), k


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_of_a_band_equals_the_whole_frames_rows(align_corners):
    """``resize_bilinear`` with ``rows`` and ``in_rows`` (what
    ``space.resize_rows`` gives a band): the second of two bands of an os4
    map, with a row of the first band above it and a zero row below the
    frame, resized x4 gives the whole frame's resize's rows bit for bit; a
    band that lacks a row the kept rows read raises."""
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 16, 8).astype(np.float32))
    whole = resize_bilinear(x, (64, 32), align_corners)
    band = torch.cat([x[..., 7:, :], torch.zeros_like(x[..., :1, :])], -2)
    got = resize_bilinear(band, (64, 32), align_corners, rows=(32, 64), in_rows=(7, 16))
    assert torch.equal(got, whole[..., 32:, :])
    with pytest.raises(ValueError, match="do not hold the input rows"):
        resize_bilinear(x[..., 9:, :], (64, 32), align_corners, rows=(32, 64), in_rows=(9, 16))
