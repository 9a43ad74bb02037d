"""Block capacity against quality on human-like uncertainty bands (port of
``tools/cap_quality.py``).

The ladder keeps at most ``cap = round(cap_frac * n * nb)`` of a frame's
64-px blocks (``n`` instance maps of ``nb`` blocks). This study draws
procedural human-like alphas (``procedural_alpha``: head, torso and legs
as filled ellipses, a 1-4 px soft edge, hair strands of partial alpha,
occlusion front to back), takes each scene's eval uncertainty map
(``compute_unknown`` at k=30: K2 on the card, its twin on the CPU) and its
active os8 sites (``active_pyramid``), scores each block by its active
sites, and reports for each capacity the share of active sites that the
top-``cap`` blocks drop: the weight-free part of the block ladder's drift
from the dense oracle (kept sites are computed exactly, dropped ones fall
back to the os8 alpha).

    python -m maggie_tpu_torch.tools.cap_quality [n_scenes] [H] [W] [--device cpu]

Defaults 50 scenes at 576x1024 on the card. The alphas are drawn on the
host with numpy (``data/imgproc.py``'s replicas of cv2's filled ellipse and
float Gaussian blur), equal to the JAX tool's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..data import imgproc

CAPS = (0.3, 0.5, 0.7, 1.0)
BLOCK = 64


def procedural_alpha(seed: int, h: int, w: int, n_i: int | None = None) -> np.ndarray:
    """(n_i, h, w) float32 alphas of occluding human-like figures (the JAX
    tool's draws from ``RandomState(seed)``, in its order)."""
    rs = np.random.RandomState(seed)
    n_i = n_i or rs.randint(2, 5)
    alphas = []
    for j in range(n_i):
        m = np.zeros((h, w), np.float32)
        cx = int((j + 1) * w / (n_i + 1) + rs.randint(-w // 10, w // 10))
        top = rs.randint(h // 12, h // 4)
        body_w = rs.randint(w // 14, w // 7)
        head_r = max(body_w // 2, 6)
        # head, torso and legs as filled ellipses
        imgproc.fill_ellipse(m, (cx, top + head_r), (head_r, int(head_r * 1.2)), 1.0)
        imgproc.fill_ellipse(m, (cx, min(top + head_r * 3 + h // 5, h - 1)), (body_w, h // 4), 1.0)
        for side in (-1, 1):
            imgproc.fill_ellipse(m, (cx + side * (body_w // 2), min(top + head_r * 2 + h // 2, h - 1)),
                                 (body_w // 3, h // 5), 1.0)
        # a soft edge of 1-4 px
        m = imgproc.gaussian_blur_f32(m, int(rs.choice([3, 5, 7, 9])))
        # hair strands: random walks of partial alpha up from the head's top
        for _ in range(rs.randint(10, 40)):
            x = cx + rs.randint(-head_r, head_r)
            y = top
            a = rs.uniform(0.2, 0.8)
            for _ in range(rs.randint(8, 30)):
                if not (0 <= x < w and 0 <= y < h):
                    break
                m[y, x] = max(m[y, x], a)
                x += rs.randint(-1, 2)
                y -= rs.randint(0, 2)
        alphas.append(m)
    # occlusion, front (j = 0) to back
    out = np.stack(alphas)
    acc = np.zeros((h, w), np.float32)
    for j in range(n_i):
        out[j] = out[j] * (1.0 - acc)
        acc = acc + out[j] * (1.0 - acc)
    return np.clip(out, 0.0, 1.0)


def scene_stats(alpha, caps=CAPS):
    """(dropped active share per capacity (len(caps),), active-block share),
    float32 tensors on ``alpha``'s device, of one scene's (n, h, w) alphas."""
    import torch
    from ..models.sparse_layers import active_pyramid
    from ..ops.kernels.unknown import compute_unknown

    n, h, w = alpha.shape
    nb = (h // BLOCK) * (w // BLOCK)
    unk = compute_unknown(alpha[None], k_size=30)[0]
    _, _, _, m8 = active_pyramid(unk.reshape(n, 1, h, w))
    g = BLOCK // 8
    scores = m8[:, 0].reshape(n, h // BLOCK, g, w // BLOCK, g).sum((2, 4)).reshape(-1)
    total = torch.clamp(scores.sum(), min=1.0)
    drops = []
    for cap_frac in caps:
        cap = max(int(round(cap_frac * n * nb)), 1)
        top = torch.topk(scores, min(cap, scores.shape[0])).values
        drops.append(1.0 - top.sum() / total)
    return torch.stack(drops), (scores > 0).float().mean()


def run(n_scenes: int, h: int, w: int, device, caps=CAPS) -> dict:
    """Every scene's drops (n_scenes, len(caps)) and active share, and the
    host seconds each ``procedural_alpha`` took."""
    import torch
    drops, actives, alpha_s = [], [], []
    for s in range(n_scenes):
        t0 = time.perf_counter()
        alpha = procedural_alpha(s, h, w)
        alpha_s.append(time.perf_counter() - t0)
        d, af = scene_stats(torch.from_numpy(alpha).to(device), caps)
        drops.append(d.cpu().numpy())
        actives.append(float(af))
    return {"drops": np.stack(drops), "actives": actives, "alpha_s": alpha_s}


def table(res: dict, n_scenes: int, h: int, w: int, caps=CAPS) -> str:
    """The JAX tool's printed table, letter for letter."""
    nb = (h // BLOCK) * (w // BLOCK)
    drops, actives = res["drops"], res["actives"]
    lines = [f"{n_scenes} procedural scenes @ {h}x{w}, block 64, "
             f"{nb} blocks/instance; active-block fraction "
             f"mean {np.mean(actives):.3f} max {np.max(actives):.3f} "
             f"(capacity is exceeded only above the cap fraction)",
             f"{'cap':>5} {'mean drop%':>10} {'p95 drop%':>10} {'scenes w/ drop':>14}"]
    for i, c in enumerate(caps):
        col = drops[:, i] * 100
        lines.append(f"{c:5.1f} {col.mean():10.3f} {np.percentile(col, 95):10.3f} "
                     f"{(col > 0).sum():>8}/{n_scenes}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_scenes", nargs="?", type=int, default=50)
    ap.add_argument("h", nargs="?", type=int, default=576)
    ap.add_argument("w", nargs="?", type=int, default=1024)
    ap.add_argument("--device", default=None, help="'cpu' for the plain twins; the card by default")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    res = run(args.n_scenes, args.h, args.w, resolve_device(args.device))
    print(table(res, args.n_scenes, args.h, args.w))
    return res


if __name__ == "__main__":
    main()
