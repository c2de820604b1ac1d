"""Typed experiment configuration for the PyTorch port.

A copy of the part of the JAX package's configuration that the port reads:
the model fields that change what the network computes (and a few that
neither model reads, kept for the config files), and the whole data,
optimizer and trainer sections that the training run reads. Routing knobs
that only pick between exact rewrites of the same maths on a TPU have no
counterpart here. Every field that both packages have keeps the JAX
default. `load_config` reads the same
JSON layouts (this package's, the JAX package's and the reference
`arch.args` / `data_loader` / `optimizer.args` layout) and ignores keys it
does not know; `save_config` writes this package's layout, which the JAX
`load_config` reads back.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ViTConfig:
    twin: bool = True  # False: the reference's flag for the DINO ViT (model_type "dino")
    rescale: float = 0.5  # backbone input size over the image size
    do_vit: bool = True  # read by neither model (kept for the config files)
    patch_size: int = 16  # DINO ViT patch
    qk_scale: str | float = "default"  # DINO attention scale: "default" or a log-N base
    vit_arch: str = "alt_gvt_small"  # alt_gvt_small/base/large | vit_small | vit_base
    vit_path: str = ""  # pretrained backbone .pth merged at init (train CLI --vit_path)
    vit_ch: Any = field(default_factory=lambda: [64, 128, 256, 512])  # DINO: an int, else 384
    out_ch: int = 64
    att_fusion: bool = True  # DINO: CLS-attention fusion in the ViT decoder
    nhead: int = 6  # read by neither model (the heads are the ViT preset's)
    multi_scale_decoder: bool = False  # read by neither model (as in the JAX package)
    cross_att: bool = False  # read by neither model: the JAX DINOMVSNet builds its ViT
    # without it, so the cross-view blocks exist only in `DINOViT(cross_att=True)`
    drop_path_rate: float | None = None  # stochastic depth; None = the preset's


@dataclass
class ModelConfig:
    model_type: str = "twin"  # "twin" (MVSFormer) | "dino" (MVSFormer-P)
    fix: bool = False  # freeze the backbone in training
    depth_type: str = "ce"  # ce | re | was | mixup_ce
    mask_out_range: bool = False  # re loss: drop pixels whose depth is outside the hypotheses
    focal: bool = False  # focal cross-entropy in the ce loss
    gamma: float = 2.0  # its focusing exponent
    fusion_type: str = "cnn"  # cnn | epipole | epipoleV2
    inverse_depth: bool = True
    attn_temp: float = 2.0  # epipole fusion's fixed softmax temperature
    base_ch: int = 8  # correlation groups G
    model_th: int = 8  # ndepth threshold selecting CostRegNet3D vs CostRegNet
    ndepths: Any = field(default_factory=lambda: [32, 16, 8, 4])
    feat_chs: Any = field(default_factory=lambda: [8, 16, 32, 64])
    depth_interals_ratio: Any = field(default_factory=lambda: [4.0, 2.67, 1.5, 1.0])
    multi_scale: bool = False
    norm_type: str = "BN"  # BN | GN | IN | none
    clamp_eth3d: bool = False  # ETH3D clamped inverse-depth schedulers
    eval_view_chunk: int = 0  # >0: eval backbone runs views in chunks
    remat_backbone: bool = False  # training: recompute the backbone in the backward
    vit_args: ViTConfig = field(default_factory=ViTConfig)


@dataclass
class MultiScaleConfig:
    # The training crop sizes (H, W); consecutive batches cycle through them
    # in reverse order, one size a batch.
    scales: Any = field(default_factory=lambda: [
        [512, 640], [512, 704], [512, 768],
        [576, 704], [576, 768], [576, 832],
        [640, 832], [640, 896], [640, 960],
        [704, 896], [704, 960], [704, 1024],
        [768, 960], [768, 1024], [768, 1088],
        [832, 1024], [832, 1088], [832, 1152],
        [896, 1152], [896, 1216], [896, 1280],
        [960, 1216], [960, 1280], [960, 1344],
        [1024, 1280],
    ])
    # The crop's enlargement range before the resize (a random factor a sample).
    resize_range: Any = field(default_factory=lambda: [1.0, 1.2])
    # Micro-batch size by image height: a batch of taller images is split
    # into micro-batches of this many samples, whose gradients are averaged.
    scale_batch_map: Any = field(default_factory=lambda: {
        "512": 4, "576": 4, "640": 4, "704": 2, "768": 2, "832": 2,
        "896": 1, "960": 1, "1024": 1,
    })


@dataclass
class AugConfig:
    """The colour jitter and gamma ranges, one draw shared by a sample's views."""
    brightness: float = 0.2
    contrast: float = 0.1
    saturation: float = 0.1
    hue: float = 0.05
    min_gamma: float = 0.9
    max_gamma: float = 1.1


@dataclass
class DataConfig:
    type: str = "DTULoader"  # DTULoader | BlendedLoader
    data_set_type: str = "multi_scale"
    datapath: str = ""
    train_data_list: str = ""
    val_data_list: str = ""
    mode: str = "train"
    nviews: int = 5
    num_depths: int = 192
    multi_scale: bool = True
    multi_scale_args: MultiScaleConfig = field(default_factory=MultiScaleConfig)
    interval_scale: float = 1.06
    resize_scale: float = 0.5  # validation's resize of the original images
    height: int = 512  # validation's centre crop (training's without multi_scale)
    width: int = 640
    shuffle: bool = True
    seq_size: int = 7
    batch_size: int = 8
    crop: bool = True  # random crops in training (centre crops otherwise)
    consist_crop: bool = False  # one crop offset for all views of a sample
    num_workers: int = 4  # loader threads
    augment: bool = True
    aug_args: AugConfig = field(default_factory=AugConfig)


@dataclass
class OptimizerConfig:
    vit_lr: float = 3.0e-5  # learning rate of the backbone (`vit.*`)
    lr: float = 1.0e-3  # learning rate of everything else
    weight_decay: float = 0.01  # decoupled, on the backbone's matrices only
    layer_decay: float = 0.75  # DINO: block i's LR is vit_lr * layer_decay^(depth - i)
    min_lr: float = 0.01  # final LR as a fraction of peak
    warmup_steps: int = 500
    grad_norm: float | None = None  # global-norm clip; None = no clip


@dataclass
class TrainerConfig:
    epochs: int = 15
    save_dir: str = "saved/"  # the run dir is save_dir/models/<name>
    save_period: int = 1  # model_last every this many epochs
    save_every_steps: int = 0  # >0: a mid-epoch model_step checkpoint every N steps
    logging_every: int = 100
    early_stop: int = 10  # stop after this many validations without improvement
    depth_scale: float = 1.0
    eval_freq: int = 1  # validate every this many epochs
    monitor: str = "min mean_error"


@dataclass
class Config:
    """The model, data, optimizer and trainer sections of an experiment
    config, as far as the ported code reads them."""
    name: str = "MVSFormer-TPU"
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
    reference layout (`arch.args`, `data_loader[0].args`,
    `optimizer.args`); unknown sections and keys are ignored.
    """
    raw: dict = {}
    if path:
        with open(path) as f:
            raw = json.load(f)
    if "arch" in raw and isinstance(raw["arch"], dict) and "args" in raw["arch"]:
        raw["arch"] = dict(raw["arch"]["args"])
    if "data_loader" in raw:
        dl = raw.pop("data_loader")
        entry = dl[0] if isinstance(dl, list) else dl
        raw["data"] = dict(entry.get("args", {}), type=entry.get("type", "DTULoader"))
    if "optimizer" in raw and "args" in raw.get("optimizer", {}):
        raw["optimizer"] = dict(raw["optimizer"]["args"])
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


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
