"""AverageMeter (a copy of ``maggie_tpu/utils/meters.py``; reference
``maggie/utils/dist.py:67-88``)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"
