"""Matting metric suite, host-side (port of ``maggie_tpu/utils/metrics.py``;
reference ``maggie/utils/metric.py``).

The formulas are the JAX package's, quirks included:
- ``MAD``/``MSE``: per-map mean of the masked diff DIVIDED AGAIN by the mask sum,
  scaled by 1e10 (``metric.py:88-98``);
- ``SAD``: masked abs-diff sum x 1e-3, count = number of maps (``metric.py:70-78``);
- ``Grad``: derivative-of-Gaussian (sigma=1.4) gradient magnitude on BATCH-min-max
  normalized maps, squared-diff masked sum x 1e-3 (``metric.py:352-420``); the
  filter is ``torch.nn.functional.conv2d`` on CPU tensors with zero padding, as
  the reference computes it (the JAX package uses ``cv2.filter2D``);
- ``Conn``: per-map connectivity error with an 11-threshold largest-connected-
  component sweep at 4-connectivity x 1e-3 (``metric.py:224-289``; scipy);
- ``dtSSD``: sqrt over (batch,frame,H,W)-summed masked temporal-derivative error per
  instance, x 0.1, masked by the PREVIOUS frame's unknown region (``metric.py:422-448``).

- ``MESSDdt``: the per-instance flow-warped temporal error of consecutive
  frames (``metric.py:450-531``) on ``ops/optical_flow.py``'s replica of cv2's
  Farneback flow, with the reference's x/y swap in the warp and its gather
  from the first frame's plane (``_torch_take``).

Metrics accumulate (score, count); ``gather_metric`` sums them over
the processes of ``torch.distributed`` when it is initialized.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def _metric_workers() -> int:
    """Host-side metric parallelism width (threads: scipy's labelling and large
    numpy ufuncs release the GIL). Override with MAGGIE_METRIC_WORKERS; default
    = host cores."""
    try:
        return max(int(os.environ.get("MAGGIE_METRIC_WORKERS", os.cpu_count() or 1)), 1)
    except ValueError:
        return 1


def _parallel_map(fn, items: list):
    """Ordered map, threaded when it can help. Every caller combines the
    results in item order, so the output is bit-identical to the serial loop."""
    if _metric_workers() <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(_metric_workers(), len(items))) as ex:
        return list(ex.map(fn, items))


def _reshape2d(x: np.ndarray) -> np.ndarray:
    return x.reshape(-1, *x.shape[-2:])


class Metric:
    def __init__(self):
        self.reset()

    def reset(self):
        self.score = 0.0
        self.count = 0.0

    def compute_metric(self, pred, gt, mask, **kw):
        raise NotImplementedError

    def trimap_mask(self, trimap, gt):
        if trimap is not None:
            return (trimap > 0).astype("float32")
        return np.ones_like(gt, dtype="float32")

    def update(self, pred, gt, trimap=None, **kw):
        mask = self.trimap_mask(trimap, gt)
        pred, gt, mask = _reshape2d(pred), _reshape2d(gt), _reshape2d(mask)
        score, count = self.compute_metric(pred, gt, mask, **kw)
        self.score += score
        self.count += count
        return score * 1.0 / count

    def average(self):
        return self.score / (self.count + 1e-6)

    def gather_metric(self):
        """Sum the score and the count over the ranks (``parallel/``)."""
        from .. import parallel
        if parallel.world() > 1:
            t = parallel.host_all_reduce(torch.tensor([self.score, self.count],
                                                      dtype=torch.float64))
            self.score, self.count = float(t[0]), float(t[1])


class SAD(Metric):
    def compute_metric(self, pred, gt, mask, **kw):
        sad = np.abs(pred - gt) * mask
        return sad.sum(axis=(1, 2)).sum() * 1e-3, mask.shape[0]


class MSE(Metric):
    def compute_metric(self, pred, gt, mask, **kw):
        diff = np.square(pred - gt) * mask
        mse = np.mean(diff, axis=(1, 2)) / (mask.sum(axis=(1, 2)) + 1e-6)
        return mse.sum() * 1e10, mask.shape[0]


class MAD(Metric):
    def compute_metric(self, pred, gt, mask, **kw):
        diff = np.abs(pred - gt) * mask
        mad = np.mean(diff, axis=(1, 2)) / (mask.sum(axis=(1, 2)) + 1e-6)
        return mad.sum() * 1e10, mask.shape[0]


class MAD_fg(MAD):
    def trimap_mask(self, trimap, gt):
        assert trimap is not None
        return (trimap == 2).astype("float32")


class MAD_bg(MAD):
    def trimap_mask(self, trimap, gt):
        assert trimap is not None
        return (trimap == 0).astype("float32")


class MAD_unk(MAD):
    def trimap_mask(self, trimap, gt):
        assert trimap is not None
        return (trimap == 1).astype("float32")


def _gauss_filters(sigma: float = 1.4, epsilon: float = 1e-2):
    def gaussian(x):
        return np.exp(-x ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * np.pi))

    def dgaussian(x):
        return -x * gaussian(x) / sigma ** 2

    half = np.ceil(sigma * np.sqrt(-2 * np.log(np.sqrt(2 * np.pi) * sigma * epsilon)))
    size = int(2 * half + 1)
    fx = np.zeros((size, size))
    for i in range(size):
        for j in range(size):
            fx[i, j] = gaussian(i - half) * dgaussian(j - half)
    fx = fx / np.sqrt((fx ** 2).sum())
    return fx.astype(np.float32), fx.T.astype(np.float32)


class Grad(Metric):
    def __init__(self):
        super().__init__()
        fx, fy = _gauss_filters(1.4)
        self.filters = torch.from_numpy(np.stack([fx, fy])[:, None])   # (2, 1, k, k)

    def _grad_mag(self, img: np.ndarray) -> np.ndarray:
        """Gradient magnitude of each (H, W) map: cross-correlation with zero
        padding (``F.conv2d``), on the CPU."""
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))[:, None]
        g = F.conv2d(x, self.filters, padding=self.filters.shape[-1] // 2)
        return torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2).numpy()

    def compute_metric(self, pred, gt, mask, **kw):
        # batch-global min-max normalization (metric.py:397-398)
        gtn = (gt - gt.min()) / (gt.max() - gt.min() + 1e-6)
        prn = (pred - pred.min()) / (pred.max() - pred.min() + 1e-6)
        diff = np.square(self._grad_mag(gtn) - self._grad_mag(prn)) * mask
        return float(diff.sum()) * 1e-3, pred.shape[0]


def _largest_cc(intersection: np.ndarray) -> np.ndarray:
    """4-connectivity largest connected component (skimage connectivity=1 equiv)."""
    from scipy import ndimage
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.int32)
    cc, num = ndimage.label(intersection, structure=structure)
    omega = np.zeros_like(intersection)
    if num > 0:
        sizes = np.bincount(cc.ravel())[1:]
        omega[cc == (np.argmax(sizes) + 1)] = 1
    return omega


class Conn(Metric):
    def compute_metric(self, pred, gt, mask, **kw):
        step = 0.1
        B = pred.shape[0]
        thresh = np.arange(0, 1 + step, step)
        # the largest-CC sweeps are independent per (map, threshold); only the
        # round_down combine is ordered, so the result equals the serial loop's
        tasks = [(b, i) for b in range(B) for i in range(1, len(thresh))]

        def omega_is_zero(t):
            b, i = t
            inter = ((gt[b] >= thresh[i]) & (pred[b] >= thresh[i])).astype(np.uint8)
            return _largest_cc(inter) == 0

        zeros = _parallel_map(omega_is_zero, tasks)
        round_down = -np.ones_like(gt)
        for (b, i), z in zip(tasks, zeros):
            m = (round_down[b] == -1) & z
            round_down[b][m] = thresh[i - 1]
        round_down[round_down == -1] = 1
        gt_diff = gt - round_down
        pred_diff = pred - round_down
        gt_phi = 1 - gt_diff * (gt_diff >= 0.15)
        pred_phi = 1 - pred_diff * (pred_diff >= 0.15)
        conn_diff = np.sum(np.abs(gt_phi - pred_phi) * mask)
        return float(conn_diff) * 1e-3, B


class dtSSD(Metric):
    def update(self, pred, gt, trimap=None, **kw):
        if trimap is not None:
            mask = (trimap == 1).astype("float32")
        else:
            mask = np.ones_like(gt, dtype="float32")
        if pred.ndim == 4:
            pred, gt, mask = pred[None], gt[None], mask[None]
        dadt = pred[:, 1:] - pred[:, :-1]
        dgdt = gt[:, 1:] - gt[:, :-1]
        mask_0 = mask[:, :-1]
        err_m = np.square(dadt - dgdt) * mask_0
        err = np.sqrt(np.sum(err_m, axis=(0, 1, 3, 4)))  # per-instance
        err = float(np.sum(err)) * 0.1
        num = mask_0.shape[2]
        self.score += err
        self.count += num
        return err / (num + 1e-10)


class MESSDdt(Metric):
    @staticmethod
    def _flow(prev, curr):
        from ..ops.optical_flow import farneback_flow
        return farneback_flow(prev.astype(np.uint8), curr.astype(np.uint8))

    def _single_video(self, pred, gt, mask):
        pred, gt = _reshape2d(pred), _reshape2d(gt)
        frames = [t for t in (gt * 255)]
        flows = np.stack([self._flow(p, c) for p, c in zip(frames[:-1], frames[1:])])
        flow = np.rint(flows).astype(np.int64)

        pred_0, pred_1 = pred[:-1], pred[1:]
        tgt_0, tgt_1 = gt[:-1], gt[1:]
        mask_0, mask_1 = mask[:-1], mask[1:]
        B, h, w = tgt_0.shape
        # the reference's coordinates (metric.py:482-489): torch.meshgrid([y, x])
        # unpacked as (xx, yy) puts the COLUMN index in channel 0, so the warp
        # adds the flow's dx to the column but clamps it with h, and dy to the
        # row clamped with w; the published numbers bake that swap in
        row, col = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        coords = np.stack([col, row], axis=2)[None].repeat(B, axis=0)
        cn = coords + flow
        cy = np.clip(cn[..., 0], 0, h - 1)
        cx = np.clip(cn[..., 1], 0, w - 1)
        idx = cy * w + cx
        pred_1 = _torch_take(pred_1, idx)
        tgt_1 = _torch_take(tgt_1, idx)
        mask_1 = _torch_take(mask_1, idx)

        error_map = np.square(pred_0 - tgt_0) * mask_0 - np.square(pred_1 - tgt_1) * mask_1
        error = np.abs(error_map).reshape(B, -1).sum(axis=1)
        num = mask_0.reshape(B, -1).sum(axis=1) + 1.0
        return error.sum() / num.sum()

    def update(self, pred, gt, trimap=None, **kw):
        if pred.ndim == 5:
            pred, gt = pred[0], gt[0]
            if trimap is not None and trimap.ndim == 5:
                trimap = trimap[0]
        if trimap is not None:
            mask = (trimap == 1).astype("float32")
        else:
            mask = np.ones_like(gt, dtype="float32")

        def per_instance(i):
            # the reference swallows per-instance failures (its multiprocessing
            # pool, metric.py:450-531): an error is printed and the instance skipped
            try:
                return self._single_video(pred[:, i], gt[:, i], mask[:, i])
            except Exception as exc:
                print(exc)
                return None

        error, count = 0.0, 0
        for e in _parallel_map(per_instance, list(range(pred.shape[1]))):
            if e is None:
                continue
            error += e * 10000
            count += 1
        self.score += error
        self.count += count
        return error / (count + 1e-8)


def _torch_take(a: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``torch.take(tensor (B, h, w), indices (B, h, w))``: flat offsets into the
    WHOLE tensor. The reference builds idx = y*w + x without a batch offset, so
    every frame gathers from frame 0's plane (metric.py:489-492)."""
    return a.ravel()[idx.ravel()].reshape(idx.shape)


METRICS = {
    "SAD": SAD, "MSE": MSE, "MAD": MAD,
    "MAD_fg": MAD_fg, "MAD_bg": MAD_bg, "MAD_unk": MAD_unk,
    "Grad": Grad, "Conn": Conn, "dtSSD": dtSSD, "MESSDdt": MESSDdt,
}


def build_metric(metrics: list[str]) -> dict[str, Metric]:
    """Explicit registry replacing the reference's ``eval`` (metric.py:534-546)."""
    out = {}
    for m in metrics:
        if m not in METRICS:
            raise NotImplementedError(f"metric {m} is not implemented")
        out[m] = METRICS[m]()
    return out
