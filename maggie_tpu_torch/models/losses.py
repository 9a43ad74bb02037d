"""Matting losses (port of ``maggie_tpu/models/losses.py``; reference
``maggie/network/loss.py`` and ``arch/maggie.py:237-266``).

- ``regression_loss``: weighted L1/L2 normalized by sum(weight) + 1e-8;
- ``gradient_loss``: L1 between normalized-Sobel magnitudes, replicate padding;
- ``lap_loss``: 3-level Laplacian pyramid (binomial 5x5 kernel, reflect padding,
  zero-interleave upsample) with a subsampled weight pyramid;
- ``loss_dtssd``: temporal-derivative L2, whose denominator adds 1e-6 per
  element as the reference's ``torch.sum(mask + 1e-6)`` does.

Maps are (..., h, w); ``lap_loss`` takes (n, 1, h, w). Everything runs in f32.

Each loss is a masked mean, sum(...) / sum(weight). Under data parallelism
(``parallel/``) a rank's term is its own numerator over the GLOBAL
denominator (all-reduced, detached; an ``eps`` per element counts the global
elements), so the ranks' terms sum to the loss of the global batch, as the
JAX package's sharded step computes it; an unweighted mean is the local sum
over the global count. Row-sharded (``parallel/space.py``), the maps are
bands: the same sums, and the Sobel and Gaussian filters take their padding
rows from the neighbour bands (the frame's own edges keep replicate and
reflect; the pyramid's ``[::2]`` needs the even band offsets whole 64-row
blocks give).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from ..parallel import space


def regression_loss(logit: torch.Tensor, target: torch.Tensor, loss_type: str = "l1",
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    if loss_type not in ("l1", "l2"):
        raise NotImplementedError(loss_type)
    dist = torch.abs if loss_type == "l1" else torch.square
    if weight is None:
        return parallel.global_mean(dist(logit - target))
    return (dist(logit * weight - target * weight).sum()
            / (parallel.global_sum(weight.sum()) + 1e-8))


def loss_dtssd(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """pred, gt, mask: (b, n_f, n_i, h, w). Reference ``_loss_dtSSD`` (loss.py:7-16)."""
    dadt = pred[:, 1:] - pred[:, :-1]
    dgdt = gt[:, 1:] - gt[:, :-1]
    m = mask[:, 1:]
    return (((dadt - dgdt) ** 2 * m).sum()
            / (parallel.global_sum(m.sum()) + 1e-6 * (m.numel() * parallel.world())))


_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32) / 8.0
_GAUSS = np.outer([1.0, 4.0, 6.0, 4.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0]).astype(np.float32) / 256.0


def sobel_magnitude(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """|grad| of each (h, w) map of x (..., h, w), Sobel kernels normalized by
    their absolute sum, replicate padding."""
    h, w = x.shape[-2:]
    y = space.pad(x.reshape(-1, 1, h, w).float(), (1, 1, 1, 1), "replicate")
    k = torch.from_numpy(np.stack([_SOBEL_X, _SOBEL_X.T])[:, None]).to(x.device)
    g = F.conv2d(y, k)
    mag = torch.sqrt(g[:, 0] ** 2 + g[:, 1] ** 2 + eps)
    return mag.reshape(x.shape)


def gradient_loss(logit: torch.Tensor, label: torch.Tensor, mask: torch.Tensor | None = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """Reference ``GradientLoss.forward`` (loss.py:73-88)."""
    if mask is None:
        return parallel.global_mean(torch.abs(sobel_magnitude(logit) - sobel_magnitude(label)))
    diff = torch.abs(sobel_magnitude(logit * mask) - sobel_magnitude(label * mask))
    return diff.sum() / (parallel.global_sum(mask.sum()) + eps)


def _conv_gauss(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 Gaussian with reflect padding 2 (loss.py:143-146), (n, c, h, w)."""
    c = x.shape[1]
    k = torch.from_numpy(_GAUSS * scale).to(x.device).expand(c, 1, 5, 5)
    return F.conv2d(space.pad(x, (2, 2, 2, 2), "reflect"), k, groups=c)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-interleave 2x, then smooth with 4x the Gaussian (loss.py:134-141)."""
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, 2 * h, 2 * w))
    up[..., ::2, ::2] = x
    return _conv_gauss(up, scale=4.0)


def laplacian_pyramid(x: torch.Tensor, max_levels: int = 3) -> list[torch.Tensor]:
    pyr, cur = [], x
    for _ in range(max_levels):
        down = _conv_gauss(cur)[..., ::2, ::2]
        pyr.append(cur - _upsample(down))
        cur = down
    return pyr


def lap_loss(inp: torch.Tensor, target: torch.Tensor, weight: torch.Tensor | None = None,
             max_levels: int = 3) -> torch.Tensor:
    """inp, target, weight: (n, 1, h, w)."""
    pi = laplacian_pyramid(inp.float(), max_levels)
    pt = laplacian_pyramid(target.float(), max_levels)
    total = 0.0
    w = None if weight is None else weight.float()
    for a, b in zip(pi, pt):
        if w is None:
            total = total + parallel.global_mean(torch.abs(a - b))
        else:
            total = total + (torch.abs(a - b) * w).sum() / (parallel.global_sum(w.sum()) + 1e-6)
            w = w[..., ::2, ::2]
    return total
