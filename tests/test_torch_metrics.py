"""The port's metric suite and postprocessing against ``maggie_tpu.utils`` on
the same numpy-seeded maps.

Tolerances: the numpy metrics (SAD, MSE, MAD and its three regions, Conn,
dtSSD), ``reverse_transform`` and ``postprocess`` are copies and must be
equal; ``Grad`` filters with ``torch.nn.functional.conv2d`` where the JAX
package calls ``cv2.filter2D``, and is held to rtol 1e-5.
"""

import numpy as np
import pytest

from maggie_tpu.utils import metrics as JM
from maggie_tpu.utils.postprocess import postprocess as jax_postprocess
from maggie_tpu.utils.postprocess import reverse_transform as jax_reverse
from maggie_tpu_torch.utils import metrics as PM
from maggie_tpu_torch.utils.postprocess import postprocess, reverse_transform


def _maps(seed, shape=(1, 3, 97, 131)):
    """(pred, gt, trimap): soft blobs, pred = gt + noise, clamped as eval clamps."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[-2], 0:shape[-1]]
    gt = np.zeros(shape, np.float32)
    for j in range(shape[1]):
        d = np.hypot(yy - shape[-2] / 2 + 5 * j, xx - 25 - 35 * j)
        gt[0, j] = np.clip((30 - d) / 9, 0, 1)
    pred = np.clip(gt + rs.normal(0, 0.08, shape), 0, 1).astype(np.float32)
    pred[pred <= 1 / 255] = 0
    pred[pred >= 254 / 255] = 1
    trimap = np.where(gt > 0.5, 2.0, 0.0).astype(np.float32)
    trimap[(gt > 0.02) & (gt < 0.98)] = 1.0
    return pred, gt, trimap


@pytest.mark.parametrize("name", ["SAD", "MSE", "MAD", "MAD_fg", "MAD_bg", "MAD_unk", "Conn"])
def test_metric_equals_jax(name):
    port, ref = PM.build_metric([name])[name], JM.build_metric([name])[name]
    for seed in range(3):
        pred, gt, trimap = _maps(seed)
        tri = trimap if name.endswith(("_fg", "_bg", "_unk")) else None
        assert port.update(pred, gt, trimap=tri) == ref.update(pred, gt, trimap=tri)
    assert port.average() == ref.average() and port.count == ref.count


def test_grad_close_to_jax():
    port, ref = PM.Grad(), JM.Grad()
    for seed in range(3):
        pred, gt, _ = _maps(seed)
        np.testing.assert_allclose(port.update(pred, gt), ref.update(pred, gt), rtol=1e-5)
    np.testing.assert_allclose(port.average(), ref.average(), rtol=1e-5)


def test_dtssd_equals_jax():
    port, ref = PM.dtSSD(), JM.dtSSD()
    frames = [_maps(s)[:2] for s in range(3)]
    pred = np.concatenate([p for p, _ in frames])          # (3 frames, n_i, H, W)
    gt = np.concatenate([g for _, g in frames])
    trimap = _maps(0)[2].repeat(3, axis=0)
    assert port.update(pred, gt, trimap=trimap) == ref.update(pred, gt, trimap=trimap)
    assert port.average() == ref.average()


def test_messddt_is_not_ported():
    """MESSDdt was the one metric of the reference the port lacked; it is
    built now, on the port's own Farneback flow (``tests/test_torch_flow.py``
    holds its values), and a metric the reference lacks still raises."""
    built = PM.build_metric(["MAD", "MESSDdt"])
    assert isinstance(built["MESSDdt"], PM.MESSDdt)
    with pytest.raises(NotImplementedError, match="not implemented"):
        PM.build_metric(["MAD", "NoSuchMetric"])


def test_gather_metric_without_a_process_group_keeps_the_sums():
    m = PM.MAD()
    pred, gt, _ = _maps(0)
    m.update(pred, gt)
    score, count = m.score, m.count
    m.gather_metric()
    assert (m.score, m.count) == (score, count)


@pytest.mark.parametrize("info", [
    [{"name": "resize", "ori_size": (150, 201), "ratio": 0.64}, {"name": "padding", "pad_size": (32, 0)}],
    [{"name": "resize", "ori_size": (96, 128), "ratio": 1.0}, {"name": "padding", "pad_size": (32, 0)}],
    [{"name": ["resize"], "ori_size": [300, 250], "ratio": [0.384]},
     {"name": ["padding"], "pad_size": [32, 0]}]])
def test_reverse_transform_equals_jax(info):
    x = np.random.RandomState(1).rand(1, 1, 2, 128, 128).astype(np.float32)
    got, ref = reverse_transform(x, info), jax_reverse(x, info)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_postprocess_equals_jax():
    pred, _, _ = _maps(4)
    pred[0, 0, 5:9, 100:104] = 0.7     # a second, smaller component
    np.testing.assert_array_equal(postprocess(pred), jax_postprocess(pred))
