"""The port's whole flagship eval forward against ``maggie_tpu`` on identical
weights and batch, and the port's block ladder against its own oracle.
Runs on the CPU, where the port's wrappers take their kernels' plain twins.

Tolerances: 1e-5 absolute on the f32 alphas, the tolerance the JAX package's
own tests hold against the original torch code; the two implementations sum
convolutions and matmuls in different orders, which moves f32 results by a
few 1e-7 at these sizes. ``detail_mask`` is a 0/1 map and must be equal; a
failure reports how many os8 alphas lie within 1e-5 of a threshold, where
float rounding alone could flip the map.
"""

import numpy as np
import pytest
import jax
import torch

from maggie_tpu.models import build_model as jax_build_model
from maggie_tpu_torch.models import build_model as port_build_model
from maggie_tpu_torch.ops.morphology import LOWER_THRES, UPPER_THRES
from test_torch_harness import (build_pair, jax_cfg, jax_shapes, jax_variables, make_batch,
                                port_cfg, port_from_flat, random_flat)

ATOL = 1e-5
KEYS = ("refined_masks", "alpha_os1", "alpha_os4", "alpha_os8")


@pytest.fixture(scope="module")
def pair():
    jm, jv, tm, flat = build_pair("block", 0.5)
    fwd = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    return jm, jv, tm, flat, fwd


def _near_threshold(alpha, eps=1e-5):
    return int((np.abs(alpha - LOWER_THRES) < eps).sum() + (np.abs(alpha - UPPER_THRES) < eps).sum())


# (0, 0): the whole map is uncertain, so every block scores the same and the
# capacity (half the blocks) overflows: the stable tie order must pick the JAX
# package's blocks. (15, 0): about a fifth of the map is uncertain (2 alphas
# lie within 1e-5 of a threshold; the port's alphas are within 4e-6).
@pytest.mark.parametrize("weights_seed,batch_seed", [(0, 0), (15, 0)])
def test_eval_forward_matches_maggie_tpu(pair, weights_seed, batch_seed):
    jm, jv, tm, flat, fwd = pair
    if weights_seed:
        flat = random_flat({k: v.shape for k, v in flat.items()}, weights_seed)
        jv = jax_variables(flat)
        tm = port_from_flat(port_cfg(jax_cfg()), flat)
    jb, tb = make_batch(n_i=2, seed=batch_seed)
    jout = jax.device_get(fwd(jv, jb))
    with torch.inference_mode():
        tout = tm(tb)
    assert set(tout) == set(KEYS) | {"detail_mask"}
    a8 = np.asarray(jout["alpha_os8"])
    near = _near_threshold(a8)
    dm_j, dm_t = np.asarray(jout["detail_mask"]), tout["detail_mask"].numpy()
    assert dm_t.shape == dm_j.shape == (1, 1, 2, 128, 192)
    np.testing.assert_array_equal(
        dm_t, dm_j, err_msg=f"{near} os8 alphas lie within 1e-5 of a threshold")
    for k in KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=ATOL,
                                   err_msg=k)


def test_block_path_equals_oracle_at_full_capacity():
    """With capacity for every block (block_cap_frac 1.0) the block-sparse
    ladder, lazy os1 shortcut included, equals the dense-masked oracle."""
    jcfg = jax_cfg(sparse_mode="block", cap_frac=1.0)
    flat = random_flat(jax_shapes(jax_build_model(jcfg.model)), seed=2)
    block = port_from_flat(port_cfg(jcfg), flat)
    ocfg = port_cfg(jax_cfg(sparse_mode="oracle"))
    oracle = port_build_model(ocfg, device="cpu")
    oracle.load_state_dict(block.state_dict())
    assert block.encoder.lazy_os1_shortcut and not oracle.encoder.lazy_os1_shortcut
    for seed in (0, 5):
        _, tb = make_batch(n_i=2, seed=seed)
        with torch.inference_mode():
            ob, oo = block(tb), oracle(tb)
        np.testing.assert_array_equal(ob["detail_mask"].numpy(), oo["detail_mask"].numpy())
        for k in KEYS:
            np.testing.assert_allclose(ob[k].numpy(), oo[k].numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"{k} seed {seed}")


def test_ladder_gathers_read_the_encoder_maps_without_a_copy(pair, monkeypatch):
    """The fea3, fea2 and lazy-os1 gathers get NHWC views that share memory
    with the encoder's NCHW tensors (no layout copy), and the forward still
    equals maggie_tpu's within 1e-5 with an equal detail_mask."""
    import maggie_tpu_torch.models.decoder_sparse as ds

    jm, jv, tm, flat, fwd = pair
    calls, enc = [], {}
    orig = ds.gather_patches

    def spy(feat, idx_n, idx_by, idx_bx, block, halo):
        calls.append((feat, block, halo))
        return orig(feat, idx_n, idx_by, idx_bx, block, halo)

    def keep(_mod, _inp, out):
        mid = out[1]
        enc.update(fea2=mid["shortcut"][1], fea3=mid["shortcut"][2],
                   sc0=mid["shortcut0_input"])

    monkeypatch.setattr(ds, "gather_patches", spy)
    handle = tm.encoder.register_forward_hook(keep)
    jb, tb = make_batch(n_i=2, seed=0)
    try:
        with torch.inference_mode():
            tout = tm(tb)
    finally:
        handle.remove()
    by_geometry = {(block, halo): feat for feat, block, halo in calls}
    assert [(b, h) for _, b, h in calls] == [(64, 32), (8, 3), (16, 4), (32, 2), (64, 5)]
    for (block, halo), name in (((16, 4), "fea3"), ((32, 2), "fea2"), ((64, 5), "sc0")):
        feat, src = by_geometry[(block, halo)], enc[name]
        assert src.is_contiguous() and src.shape[1] > 1
        assert not feat.is_contiguous(), name                    # a view, not a copy
        assert feat.untyped_storage().data_ptr() == src.untyped_storage().data_ptr(), name
        assert feat.data_ptr() == src.data_ptr(), name
        assert torch.equal(feat, src.permute(0, 2, 3, 1)), name
    jout = jax.device_get(fwd(jv, jb))
    np.testing.assert_array_equal(tout["detail_mask"].numpy(), np.asarray(jout["detail_mask"]))
    for k in KEYS:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
