"""Typed model configuration for the PyTorch port.

A copy of the part of the JAX package's configuration that the ported eval
forward and training step read: the fields that change what the network
computes, those that `build_model` rejects until a later slice ports them,
and the optimizer, batch and schedule fields of one training step. Routing
knobs that only pick between exact rewrites of the same maths on a TPU have
no counterpart here, and the data-loader, checkpoint and other-model fields
come with the slices that read them. `load_config` reads the same JSON
layouts (this package's and the reference `arch.args` layout) and ignores
keys it does not know.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ViTConfig:
    rescale: float = 0.5  # backbone input size over the image size
    vit_arch: str = "alt_gvt_small"
    out_ch: int = 64
    drop_path_rate: float | None = None  # stochastic depth; None = the preset's


@dataclass
class ModelConfig:
    model_type: str = "twin"  # "twin" (MVSFormer) | "dino" (MVSFormer-P)
    fix: bool = False  # freeze the backbone in training
    depth_type: str = "ce"  # ce | re | was | mixup_ce
    focal: bool = False  # focal cross-entropy in the ce loss
    gamma: float = 2.0  # its focusing exponent
    fusion_type: str = "cnn"  # cnn | epipole | epipoleV2
    inverse_depth: bool = True
    base_ch: int = 8  # correlation groups G
    model_th: int = 8  # ndepth threshold selecting CostRegNet3D vs CostRegNet
    ndepths: Any = field(default_factory=lambda: [32, 16, 8, 4])
    feat_chs: Any = field(default_factory=lambda: [8, 16, 32, 64])
    depth_interals_ratio: Any = field(default_factory=lambda: [4.0, 2.67, 1.5, 1.0])
    multi_scale: bool = False
    norm_type: str = "BN"  # BN | GN
    clamp_eth3d: bool = False  # ETH3D clamped inverse-depth schedulers
    eval_view_chunk: int = 0  # >0: eval backbone runs views in chunks
    vit_args: ViTConfig = field(default_factory=ViTConfig)


@dataclass
class MultiScaleConfig:
    # Micro-batch size by image height: a batch of taller images is split
    # into micro-batches of this many samples, whose gradients are averaged.
    scale_batch_map: Any = field(default_factory=lambda: {
        "512": 4, "576": 4, "640": 4, "704": 2, "768": 2, "832": 2,
        "896": 1, "960": 1, "1024": 1,
    })


@dataclass
class DataConfig:
    batch_size: int = 8
    multi_scale_args: MultiScaleConfig = field(default_factory=MultiScaleConfig)


@dataclass
class OptimizerConfig:
    vit_lr: float = 3.0e-5  # learning rate of the backbone (`vit.*`)
    lr: float = 1.0e-3  # learning rate of everything else
    weight_decay: float = 0.01  # decoupled, on the backbone's matrices only
    min_lr: float = 0.01  # final LR as a fraction of peak
    warmup_steps: int = 500
    grad_norm: float | None = None  # global-norm clip; None = no clip


@dataclass
class TrainerConfig:
    epochs: int = 15


@dataclass
class Config:
    """The model, data, optimizer and trainer sections of an experiment
    config, as far as the ported code reads them."""
    arch: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)


def _build(cls, data):
    if not dataclasses.is_dataclass(cls) or not isinstance(data, dict):
        return data
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in data.items():
        if k not in names:
            continue
        f = names[k]
        sub = None
        if f.default_factory is not dataclasses.MISSING:  # type: ignore
            probe = f.default_factory()  # type: ignore
            if dataclasses.is_dataclass(probe):
                sub = type(probe)
        kwargs[k] = _build(sub, v) if sub else v
    return cls(**kwargs)


def load_config(path: str | None = None, overrides: dict | None = None) -> Config:
    """Load a JSON config and apply dotted-path overrides.

    Accepts this package's layout, the JAX package's layout and the
    reference layout (`arch.args`); unknown sections and keys are ignored.
    """
    raw: dict = {}
    if path:
        with open(path) as f:
            raw = json.load(f)
    if "arch" in raw and isinstance(raw["arch"], dict) and "args" in raw["arch"]:
        raw["arch"] = dict(raw["arch"]["args"])
    if "arch" in raw and isinstance(raw["arch"], dict):
        va = raw["arch"].get("vit_args")
        if va and va.get("twin") is False:
            raw["arch"].setdefault("model_type", "dino")

    cfg = _build(Config, raw)
    for dotted, value in (overrides or {}).items():
        obj = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], value)
    return cfg
