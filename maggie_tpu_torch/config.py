"""Hierarchical config tree for maggie_tpu_torch (a copy of ``maggie_tpu/config.py``).

A small, dependency-free re-implementation of the yacs ``CfgNode`` surface that the
reference uses (see reference ``maggie/utils/config.py:1-139`` and
``tools/main.py:61-113``): attribute access, ``merge_from_file`` (YAML),
``merge_from_list`` with dotted keys and type coercion, ``clone`` and YAML ``dump``.

Unlike the reference we do not keep a global mutable singleton import-side-effect;
``default_config()`` builds a fresh tree, and callers thread it explicitly.

``yaml`` is imported only inside the two methods that read or write YAML, so a
host without PyYAML can still build a config in code.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterable


class ConfigNode(dict):
    """Dict with attribute access and yacs-style merge semantics."""

    def __init__(self, init: dict | None = None, new_allowed: bool = False):
        super().__init__()
        object.__setattr__(self, "_new_allowed", new_allowed)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # ----- attribute access -----
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = ConfigNode(value) if isinstance(value, dict) and not isinstance(value, ConfigNode) else value

    # ----- merging -----
    def merge_from_other(self, other: dict, path: str = "") -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                if self._new_allowed:
                    self[k] = ConfigNode(v) if isinstance(v, dict) else v
                    continue
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite config node {full} with a leaf value {v!r}")
                cur.merge_from_other(v, full)
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_file(self, path: str) -> None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        """Merge dotted ``key value`` pairs, like yacs ``merge_from_list``.

        Also accepts the ``--key=value`` form the reference CLI supports
        (``tools/main.py:61-90``).
        """
        flat: list[str] = []
        for item in opts:
            s = str(item)
            if s.startswith("--"):
                s = s[2:]
            if "=" in s and not flat or ("=" in s and len(flat) % 2 == 0):
                k, _, v = s.partition("=")
                flat.extend([k, v])
            else:
                flat.append(s)
        if len(flat) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {flat}")
        for key, value in zip(flat[0::2], flat[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], ConfigNode):
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                if node._new_allowed:
                    node[leaf] = _parse_literal(value)
                    continue
                raise KeyError(f"Non-existent config key: {key}")
            node[leaf] = _coerce(_parse_literal(value), node[leaf], key)

    # ----- misc -----
    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()}

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False, sort_keys=True)

    def __deepcopy__(self, memo):
        node = ConfigNode(new_allowed=self._new_allowed)
        for k, v in self.items():
            node[k] = copy.deepcopy(v, memo)
        return node


def _parse_literal(value: Any) -> Any:
    if not isinstance(value, str):
        return value
    # yacs-style boolean/None words, any case: without this a NEW key on an
    # open node (e.g. model.encoder_args.s2d_stem false) would store the string
    # "false", which is truthy — a silent inversion.
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def _coerce(new: Any, old: Any, key: str) -> Any:
    """Type-coerce an override toward the default's type (yacs semantics)."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            if new.lower() in ("true", "1", "yes"):
                return True
            if new.lower() in ("false", "0", "no"):
                return False
        if isinstance(new, int):
            return bool(new)
        raise TypeError(f"Cannot coerce {new!r} to bool for key {key}")
    if isinstance(old, float) and isinstance(new, (int, str)):
        return float(new)
    if isinstance(old, int) and isinstance(new, float) and new.is_integer():
        return int(new)
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return list(new)
    if type(old) is type(new) or isinstance(new, type(old)):
        return new
    if isinstance(new, str):
        try:
            return type(old)(new)
        except (TypeError, ValueError):
            pass
    raise TypeError(f"Type mismatch for key {key}: default {type(old).__name__}, override {type(new).__name__} ({new!r})")


def default_config() -> ConfigNode:
    """Full default schema, mirroring reference ``maggie/utils/config.py:3-139``."""
    c = ConfigNode()
    c.output_dir = "logs"
    c.name = "default"

    c.train = ConfigNode()
    c.train.seed = -1
    c.train.batch_size = 2
    c.train.num_workers = 16
    c.train.resume = ""
    c.train.resume_last = False
    c.train.max_iter = 100000
    c.train.log_iter = 50
    c.train.vis_iter = 500
    c.train.val_iter = 2000
    # TPU addition (reference checkpoints only at val_iter, train.py:313-343):
    # >0 saves last_state every N iters too, so a preempted/disconnected device
    # costs at most N iters of work; tools/train_supervisor.py relies on this.
    c.train.ckpt_iter = 0
    c.train.val_metrics = ["MAD", "MSE", "dtSSD"]
    c.train.val_best_metric = "MAD"
    c.train.val_dist = True

    c.train.optimizer = ConfigNode()
    c.train.optimizer.name = "sgd"
    c.train.optimizer.lr = 1.0e-4
    c.train.optimizer.momentum = 0.9
    c.train.optimizer.weight_decay = 1.0e-2
    c.train.optimizer.betas = [0.9, 0.999]

    c.train.scheduler = ConfigNode()
    c.train.scheduler.name = "poly"
    c.train.scheduler.power = 0.9
    c.train.scheduler.step_size = 10000
    c.train.scheduler.gamma = 0.1
    c.train.scheduler.warmup_iters = 1000

    c.wandb = ConfigNode()
    c.wandb.project = "maggie"
    c.wandb.entity = "research"
    c.wandb.use = True
    c.wandb.id = ""

    c.test = ConfigNode()
    c.test.batch_size = 1
    c.test.num_workers = 4
    c.test.save_results = True
    c.test.save_dir = "logs"
    c.test.postprocessing = True
    c.test.metrics = ["MAD", "MSE", "SAD", "Conn", "Grad", "dtSSD", "MESSDdt"]
    c.test.log_iter = 50
    # pad eval batches to canonical (H, W, n_i) buckets so an M-HIM2K aspect-ratio
    # sweep compiles a handful of shapes instead of one per image (TPU-only knob;
    # the reference recompiles nothing, torch is shape-polymorphic)
    c.test.shape_bucketing = True
    # video eval: carry the ConvGRU hidden state across clip windows. The
    # reference never does (its tuple-only mem_feat carry drops the plain-tensor
    # ConvGRU state, engine/test.py:252-254) — False replicates that for parity;
    # True enables the fixed behavior.
    c.test.carry_memory = False
    # streaming video eval: carry the frame-local encoder+ASPP features of the
    # clip-overlap frames instead of recomputing them (exact; engine/test.py)
    c.test.cache_features = True

    c.model = ConfigNode()
    c.model.weights = ""
    c.model.arch = "MaGGIe"
    c.model.sync_bn = True
    c.model.having_unused_params = False
    c.model.warmup_iters = 5000
    c.model.encoder = "res_encoder_29"
    c.model.encoder_args = ConfigNode({"pretrained": True, "num_mask": 1}, new_allowed=True)
    c.model.aspp = ConfigNode({"in_channels": 512, "out_channels": 512})
    c.model.decoder = ""
    c.model.decoder_args = ConfigNode({}, new_allowed=True)
    c.model.loss_alpha_w = 1.0
    c.model.loss_alpha_type = "l1"
    c.model.loss_alpha_grad_w = 1.0
    c.model.loss_alpha_lap_w = 1.0
    c.model.loss_atten_w = 1.0
    c.model.loss_reweight_os8 = True
    c.model.loss_dtSSD_w = 1.0
    c.model.shm = ConfigNode({"lr_scale": 0.5, "dilation_kernel": 15, "max_n_pixel": 4000000, "mgm_weights": ""})

    # TPU-specific additions (absent in the reference; defaults preserve its behavior).
    c.model.precision = "fp32"  # or 'bf16'
    # remat mode: "none" | "selective" (stage-boundary checkpoints) | "full";
    # a string so CLI overrides pass through _coerce untyped
    c.model.remat = "none"

    ds = ConfigNode()
    ds.train = ConfigNode()
    ds.train.name = "VIM"
    ds.train.root_dir = ""
    ds.train.split = "train"
    ds.train.short_size = 768
    ds.train.random_state = 2023
    ds.train.crop = [512, 512]
    ds.train.max_inst = 10
    ds.train.padding_crop_p = 0.1
    ds.train.flip_p = 0.5
    ds.train.gamma_p = 0.3
    ds.train.add_noise_p = 0.3
    ds.train.jpeg_p = 0.1
    ds.train.affine_p = 0.1
    ds.train.binarized_kernel = 30
    ds.train.downscale_mask_p = 0.5
    ds.train.mask_dir_name = "masks_matched"
    ds.train.alpha_dir_name = "pha"
    ds.train.clip_length = 8
    ds.train.max_step_size = 2
    ds.train.motion_p = 0.3
    # TPU addition: decoded-image host-RAM cache budget in GB (0 = off). Input
    # pipelines on TPU VM hosts are CPU-bound; epochs revisit the same files.
    ds.train.cache_images = 0.0
    ds.test = ConfigNode()
    ds.test.name = "VIM"
    ds.test.root_dir = ""
    ds.test.split = "valid"
    ds.test.short_size = 768
    ds.test.downscale_mask = True
    ds.test.alpha_dir_name = "alphas"
    ds.test.mask_dir_name = "masks_matched"
    ds.test.clip_length = 8
    ds.test.clip_overlap = 2
    # jit-compiled device preprocessing tail for eval frames/masks (decode stays
    # host-side; metric-side alpha/trimap prep keeps the exact host path). The
    # north-star input-pipeline clause; off by default for bit-parity runs.
    ds.test.device_preprocess = False
    c.dataset = ds
    return c


def load_config(path: str | None = None, opts: Iterable[str] | None = None) -> ConfigNode:
    cfg = default_config()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return cfg
