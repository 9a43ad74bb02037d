"""The port's matting losses (``maggie_tpu_torch/models/losses.py``) against
``maggie_tpu/models/losses.py`` on the CPU.

Inputs are drawn with numpy from a seed: alphas in [0, 1] and 0/1 weights,
in the shapes ``compute_loss`` hands each loss. Values within rtol 1e-5
(f32 sums in another order); the gradient with respect to the prediction
within 1e-5 of its largest element.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maggie_tpu.models import losses as jl
from maggie_tpu_torch.models import losses as tl

RTOL = 1e-5
GRAD_REL = 1e-5


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    pred = rs.rand(*shape).astype(np.float32)
    gt = np.clip(pred + rs.randn(*shape).astype(np.float32) * 0.2, 0, 1).astype(np.float32)
    weight = (rs.rand(*shape) > 0.4).astype(np.float32)
    return pred, gt, weight


CASES = {
    "l1": (lambda m, p, g, w: m.regression_loss(p, g, "l1", w), (2, 3, 24, 20)),
    "l1_unweighted": (lambda m, p, g, w: m.regression_loss(p, g, "l1"), (2, 3, 24, 20)),
    "l2": (lambda m, p, g, w: m.regression_loss(p, g, "l2", w), (2, 3, 24, 20)),
    "l2_unweighted": (lambda m, p, g, w: m.regression_loss(p, g, "l2"), (2, 3, 24, 20)),
    "gradient_masked": (lambda m, p, g, w: m.gradient_loss(p, g, w), (2, 3, 24, 20)),
    "gradient_unmasked": (lambda m, p, g, w: m.gradient_loss(p, g), (2, 3, 24, 20)),
    "lap": (lambda m, p, g, w: m.lap_loss(p, g, w), (6, 1, 32, 40)),
    "lap_unweighted": (lambda m, p, g, w: m.lap_loss(p, g), (6, 1, 32, 40)),
    "dtssd": (lambda m, p, g, w: m.loss_dtssd(p, g, w), (2, 3, 4, 16, 20)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    fn, shape = CASES[name]
    pred, gt, weight = _inputs(shape, seed=len(name))
    want, jgrad = jax.value_and_grad(lambda p: fn(jl, p, jnp.asarray(gt), jnp.asarray(weight)))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = fn(tl, tp, torch.from_numpy(gt), torch.from_numpy(weight))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    scale = float(np.abs(np.asarray(jgrad)).max())
    assert float(np.abs(tp.grad.numpy() - np.asarray(jgrad)).max()) <= GRAD_REL * scale


def test_sobel_magnitude_matches_jax():
    """The normalized Sobel magnitude with replicate padding, map by map."""
    x = np.random.RandomState(1).rand(2, 3, 17, 23).astype(np.float32)
    np.testing.assert_allclose(tl.sobel_magnitude(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.sobel_magnitude(jnp.asarray(x))), rtol=RTOL, atol=1e-7)


def test_laplacian_pyramid_matches_jax():
    """Each level of the 3-level pyramid (reflect padding, zero-interleaved
    upsample); the JAX package's runs on NHWC."""
    x = np.random.RandomState(2).rand(3, 1, 32, 48).astype(np.float32)
    got = tl.laplacian_pyramid(torch.from_numpy(x))
    want = jl.laplacian_pyramid(jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), rtol=0, atol=1e-6)
