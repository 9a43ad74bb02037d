"""The flagship MaGGIe image configuration and the bench condition's inputs.

``flagship_cfg`` is ``configs/maggie_image.yaml`` built in code (the host that
runs the port may lack PyYAML): its model as ``__graft_entry__._image_model_cfg``
builds it, encoder ``res_shortcut_embed_29``, decoder
``res_shortcut_inst_matt_spconv_22`` at full width (atten_dim 128,
final_channel 64, num_mask 10, max_inst 10, num_embed 3), block-sparse ladder
at capacity 0.5; and its eval settings (``dataset.test`` and ``test``). ``blob_batch`` is ``bench.py::_blob_batch``'s numpy recipe:
one frame with ``n_i`` soft-disc instances and their masks at 1/8 resolution.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ConfigNode, load_config


def flagship_cfg(precision: str = "fp32") -> ConfigNode:
    cfg = load_config()
    cfg.model.arch = "MaGGIe"
    cfg.model.encoder = "res_shortcut_embed_29"
    cfg.model.encoder_args.update(dict(num_embed=3, num_mask=10))
    cfg.model.decoder = "res_shortcut_inst_matt_spconv_22"
    cfg.model.decoder_args.update(dict(
        atten_block=2, atten_dim=128, atten_head=1, atten_stride=1, final_channel=64,
        max_inst=10, use_id_pe=True, sparse_mode="block", block_cap_frac=0.5))
    cfg.model.precision = precision
    cfg.dataset.test.update(dict(
        name="HIM", root_dir="data/HIM2K_M-HIM2K", split="comp", short_size=576,
        downscale_mask=False, alpha_dir_name="alphas", mask_dir_name="masks_matched_r50_fpn_3x"))
    cfg.test.update(dict(batch_size=1, log_iter=100, metrics=["MAD", "MSE", "SAD", "Grad", "Conn"],
                         postprocessing=False, save_results=False))
    return cfg


def blob_alpha(h: int, w: int, n_i: int, rs: np.random.RandomState) -> np.ndarray:
    """(n_i, h, w) soft discs of radius h/4 with a 0.2-radius ramp."""
    yy, xx = np.mgrid[0:h, 0:w]
    alphas = []
    for j in range(n_i):
        cx = (j + 1) * w // (n_i + 1)
        cy = h // 2 + rs.randint(-h // 8, h // 8)
        r = h // 4
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        alphas.append(np.clip((r - d) / (r * 0.2), 0, 1))
    return np.stack(alphas).astype(np.float32)


def blob_batch(h: int = 576, w: int = 1024, n_i: int = 3, seed: int = 0) -> dict:
    """{'image': (1, 1, h, w, 3), 'mask': (1, 1, n_i, h/8, w/8)} CPU tensors."""
    rs = np.random.RandomState(seed)
    alpha = blob_alpha(h, w, n_i, rs)
    masks = (alpha > 0.5).astype(np.float32)[:, ::8, ::8]
    return {"image": torch.from_numpy(rs.rand(1, 1, h, w, 3).astype(np.float32)),
            "mask": torch.from_numpy(np.ascontiguousarray(masks[None, None]))}
