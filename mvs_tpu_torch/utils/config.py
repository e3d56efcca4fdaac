"""Hierarchical config: nested dataclasses + YAML file + dotted CLI overrides
(a copy of mvs_tpu.utils.config, so configs and overrides written for the
JAX package load here unchanged).

Overrides use dotted paths: ``train.lr=0.001 model.ndepths=48,32,8``.
A YAML file is read with ``load_yaml_subset`` (the card's machine has no
PyYAML): nested block mappings, inline lists, quoted and plain scalars and
comments, which is all the repo's configs use.

Fields that select TPU paths are accepted and ignored by the port: it always
samples exactly, so ``model.sampler`` ('hat' or 'gather') and the
``model.band_*`` fields change nothing, and the mesh fields of ``train``
wait for the port's distributed training.
"""

from __future__ import annotations

import dataclasses
import re

__all__ = [
    "ModelConfig", "DataConfig", "TrainConfig", "FusionCfg", "EvalConfig",
    "Config", "load_config", "apply_overrides", "config_to_dict",
    "load_yaml_subset",
]


@dataclasses.dataclass
class ModelConfig:
    name: str = "cas_mvsnet"  # mvsnet | cas_mvsnet | cvp_mvsnet | aacvp_mvsnet | point_mvsnet
    base_channels: int = 8
    normalization: str = "batch"
    # 'gather' | 'hat' in mvs_tpu; the port always samples exactly.
    sampler: str = "gather"
    # Activation dtype for the conv/warp compute path ('float32'|'bfloat16');
    # params and the regression head stay f32.
    compute_dtype: str = "float32"
    # Banded hat-warp budget of mvs_tpu; ignored by the port.
    band_tile_rows: int = 0
    band_tile_cols: int = 0
    band_h: int = 0
    band_w: int = 0
    band_depth_group: int = 0
    # MVSNet
    refine: bool = False
    # cascade
    ndepths: tuple = (48, 32, 8)
    depth_interval_ratios: tuple = (4.0, 2.0, 1.0)
    arch_mode: str = "fpn"
    share_cr: bool = False
    # pyramid (CVP/AACVP)
    num_levels: int = 2
    coarse_depths: int = 48
    num_offsets: int = 4
    cost_mode: str = "variance"
    num_groups: int = 4
    attention: bool = False
    num_heads: int = 1
    # Test-time per-scene epipolar 1-px hypothesis interval (reference
    # CVP-MVSNet/models/modules.py:146-219; train uses the fixed
    # train_interval). Set in eval configs (see configs/cvp_eval_dtu.yaml).
    use_epipolar_interval: bool = False
    train_interval: float = 6.8085
    # point
    num_depth_coarse: int = 48
    flow_scales: tuple = (0.25, 0.5)
    inter_scales: tuple = (0.75, 0.375)
    # Test-time tiled sub-flow stride (1 = untiled; see
    # models.point_mvsnet.PointMVSNet.flow_sub_stride).
    flow_sub_stride: int = 1


@dataclasses.dataclass
class DataConfig:
    root: str = ""
    train_list: str = ""
    val_list: str = ""
    eval_root: str = ""
    eval_list: str = ""
    num_views: int = 3
    num_depth: int = 192
    interval_scale: float = 1.06
    batch_size: int = 1
    num_threads: int = 2
    max_h: int = 864
    max_w: int = 1152
    align: int = 32


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 16
    lr: float = 0.001
    lr_schedule: str = "10,12,14:2"  # multistep milestones:divisor
    warmup_steps: int = 500
    weight_decay: float = 0.0
    optimizer: str = "adam"  # adam | rmsprop | sgd
    # Depth loss for the single-volume MVSNet task: 'smooth_l1' (reference
    # MVSNet/models/mvsnet.py:201-203) or 'ohem' — top-k hard-example-mined
    # smooth-L1 (reference MVSNet_pl/losses.py:4-19, top 60% by default).
    loss: str = "smooth_l1"
    ohem_topk: float = 0.6
    grad_clip: float = 0.0
    # Opt-in BatchNorm re-estimation: at the end of each epoch, replace the
    # running stats with an EQUAL-WEIGHT mean of per-batch moments over this
    # many forward passes under the FINAL params (0 = off, the reference's
    # behavior). EMA stats trail the fast-moving early-training feature
    # distributions; recalibration closes the train/eval gap on SHORT runs
    # (e.g. the e2e fixtures). On full-length (>10k step) runs the
    # accumulated EMA is the lower-variance estimate — leave this off.
    bn_recal_batches: int = 0
    seed: int = 1
    log_dir: str = "runs/default"
    ckpt_every_epochs: int = 1
    summary_every_steps: int = 20
    # mesh
    mesh_data: int = 0  # 0 = all devices on data axis
    mesh_view: int = 1  # source-view sharding (psum of Σf/Σf² partials)
    mesh_depth: int = 1
    mesh_space: int = 1


@dataclasses.dataclass
class FusionCfg:
    conf_thresh: float = 0.9
    num_consistent: int = 3
    pixel_thresh: float = 1.0
    depth_thresh: float = 0.01
    depth_mode: str = "relative"  # 'relative' (python fuser) | 'absolute' (fusibile)


@dataclasses.dataclass
class EvalConfig:
    gt_points_dir: str = ""  # DTU Points/stl
    obs_mask_dir: str = ""  # DTU ObsMask
    out_dir: str = "outputs"
    max_dist: float = 20.0
    decimation: float = 0.2


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    fusion: FusionCfg = dataclasses.field(default_factory=FusionCfg)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def _coerce(value: str, current):
    """Parse a CLI string into the type of the current field value."""
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        elem = current[0] if current else 1.0
        return tuple(type(elem)(v) for v in value.split(","))
    return value


# Renamed keys accepted with a deprecation warning: old dotted path -> new.
_DEPRECATED_KEYS = {
    "train.bf16": ("model.compute_dtype",
                   lambda v: "bfloat16" if v.lower() in ("1", "true", "yes", "on")
                   else "float32"),
}


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like section.key=value")
        path, value = ov.split("=", 1)
        if path in _DEPRECATED_KEYS:
            import warnings

            new_path, conv = _DEPRECATED_KEYS[path]
            warnings.warn(f"config key {path!r} is deprecated; use {new_path}",
                          DeprecationWarning, stacklevel=2)
            path, value = new_path, conv(value)
        parts = path.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        key = parts[-1]
        if not hasattr(obj, key):
            raise KeyError(f"unknown config key {path!r}")
        setattr(obj, key, _coerce(value, getattr(obj, key)))
    return cfg


def _merge_dict(obj, d: dict):
    for k, v in d.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key {k!r} in yaml")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur):
            _merge_dict(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            setattr(obj, k, tuple(v))
        else:
            setattr(obj, k, v)


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")


def _scalar(text: str):
    """A plain or quoted YAML scalar, typed as yaml.safe_load types it for
    the forms the configs use."""
    if text[:1] in "'\"" and len(text) > 1 and text[-1] == text[0]:
        return text[1:-1]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text) and ("." in text or text.isdigit()):
        return float(text)
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def load_yaml_subset(text: str) -> dict:
    """Parse the YAML the configs use: block mappings nested by indentation,
    `key: scalar`, `key: [a, b, ...]` and comments."""
    root: dict = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise ValueError(f"unsupported YAML line: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        node = stack[-1][1]
        value = value.strip()
        if not value:
            node[key] = {}
            stack.append((indent, node[key]))
        elif value.startswith("[") and value.endswith("]"):
            inner = value[1:-1].strip()
            node[key] = [_scalar(v.strip()) for v in inner.split(",")] \
                if inner else []
        else:
            node[key] = _scalar(value)
    return root


def _read_yaml(path) -> dict:
    with open(path) as f:
        return load_yaml_subset(f.read())


def load_config(yaml_path=None, overrides: list[str] | None = None) -> Config:
    cfg = Config()
    if yaml_path:
        _merge_dict(cfg, _read_yaml(yaml_path))
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)
