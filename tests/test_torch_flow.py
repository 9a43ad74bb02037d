"""The port's Farneback flow (``maggie_tpu_torch/ops/optical_flow.py``) against
``cv2.calcOpticalFlowFarneback`` at the metric's setting, and the port's
``MESSDdt`` against the JAX package's, which calls cv2.

cv2's blurs and resizes round some float sums otherwise than the replica (its
vector code, and Intel IPP for the larger blurs), so the flows agree to float
rounding, not bit for bit. On these fixtures (cv2 5.0.0) the largest float
difference was 1.44e-4 px (the 180x320 blob pair; 6.1e-6 to 4.5e-5 px on the
others, means under 7.7e-7 px) and every rounded flow was equal; the test asks
for 99.5% of the pixels of each pair. ``MESSDdt`` rounds the flows, so equal
rounded flows give equal metrics up to the float sums of the error: both
cases read a relative difference of 0 (rtol 1e-3 asked).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2", reason="cv2 (the reference flow) is not installed")

from maggie_tpu.utils import metrics as JM  # noqa: E402
from maggie_tpu_torch.ops.optical_flow import farneback_flow  # noqa: E402
from maggie_tpu_torch.utils import metrics as PM  # noqa: E402


def blob(h, w, cx, cy, r):
    yy, xx = np.mgrid[0:h, 0:w]
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    return np.clip((r - d) / max(r * 0.3, 1), 0, 1)


def _pairs():
    """(name, frame 0, frame 1) uint8: soft blobs that move a few pixels, and
    a smooth random texture that moves (3, 2) px, at the sizes of the port's
    tests and at the 4-level pyramid of a 180x320 frame."""
    rs = np.random.RandomState(0)
    out = []
    for h, w in ((64, 128), (88, 120), (180, 320)):
        a = blob(h, w, w * 0.3, h * 0.5, h * 0.25) + blob(h, w, w * 0.7, h * 0.4, h * 0.2)
        b = blob(h, w, w * 0.3 + 3, h * 0.5 + 1, h * 0.25) + blob(h, w, w * 0.7 - 2, h * 0.4, h * 0.2)
        out.append((f"blobs_{h}x{w}", (np.clip(a, 0, 1) * 255).astype(np.uint8),
                    (np.clip(b, 0, 1) * 255).astype(np.uint8)))
        tex = cv2.resize((rs.rand(h // 4 + 3, w // 4 + 3) * 255).astype(np.uint8),
                         (w + 12, h + 12), interpolation=cv2.INTER_CUBIC)
        out.append((f"texture_{h}x{w}", tex[:h, :w].copy(), tex[2:h + 2, 3:w + 3].copy()))
    return out


@pytest.mark.parametrize("name,f0,f1", _pairs(), ids=lambda v: v if isinstance(v, str) else "")
def test_farneback_equals_cv2(name, f0, f1):
    want = cv2.calcOpticalFlowFarneback(f0, f1, None, 0.5, 5, 10, 2, 7, 1.5,
                                        cv2.OPTFLOW_FARNEBACK_GAUSSIAN)
    got = farneback_flow(f0, f1)
    assert got.shape == want.shape and got.dtype == np.float32
    equal = float((np.rint(got) == np.rint(want)).all(axis=-1).mean())
    err = float(np.abs(got - want).max())
    assert equal >= 0.995, (name, equal, err)
    assert err < 1e-2, (name, err)
    # the pairs move: the flow is not trivially zero
    assert np.abs(np.rint(want)).max() >= 1


@pytest.mark.parametrize("h,w,trimap", [(64, 128, False), (88, 120, True)])
def test_messddt_equals_jax(h, w, trimap):
    """Three frames, two instances that move, predictions off by noise; with
    no trimap (a ones mask, as the engine passes it) and with one."""
    rs = np.random.RandomState(h)
    gt = np.stack([[blob(h, w, 30 + 40 * j + 3 * t, h / 2 + t, 18 + j) for j in range(2)]
                   for t in range(3)]).astype(np.float32)
    pred = np.clip(gt + rs.randn(*gt.shape).astype(np.float32) * 0.05, 0, 1)
    tri = None
    if trimap:
        tri = np.where(gt > 0.95, 2.0, np.where(gt > 0.05, 1.0, 0.0)).astype(np.float32)
    port, ref = PM.MESSDdt(), JM.MESSDdt()
    got = port.update(pred, gt, trimap=tri)
    want = ref.update(pred, gt, trimap=tri)
    assert want > 0 and port.count == ref.count == 2
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(port.average(), ref.average(), rtol=1e-3)
