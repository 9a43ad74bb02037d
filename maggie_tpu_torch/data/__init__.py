"""Dataset registry (port of ``maggie_tpu/data/__init__.py``): HIM and VIM,
train and eval."""

from __future__ import annotations

from typing import Any


def build_dataset(cfg: Any, is_train: bool, random_seed: int = 2023, device=None,
                  decode=None):
    """The ``dataset.test`` (or ``dataset.train``) dataset of ``cfg``. ``device``
    is where a ``device_preprocess`` sample's tensors go; ``decode(path, mode)``
    replaces the PIL decoder (``data/transforms.py::Load``)."""
    sub = cfg.dataset.train if is_train else cfg.dataset.test
    if sub.name == "HIM":
        from .him import HIMDataset as cls
    elif sub.name == "VIM":
        from .vim import VIMDataset as cls
    else:
        raise KeyError(f"Unknown dataset '{sub.name}'")
    return cls(root_dir=sub.root_dir, split=sub.split, is_train=is_train,
               random_seed=random_seed, device=device, decode=decode,
               **{k: v for k, v in sub.items() if k not in ("name", "root_dir", "split")})
