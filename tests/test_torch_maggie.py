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
