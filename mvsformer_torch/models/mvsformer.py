"""TwinMVSNet (MVSFormer), the cascade it shares with DINOMVSNet, and the
factory of both.

Port of `mvsformer_tpu/models/mvsformer.py`: FPN encoder + Twins backbone
fused by TwinDecoderStage4, then a 4-stage coarse-to-fine cascade of
StageNets with inverse-depth (or metric) hypothesis scheduling, the ETH3D
clamped forms under `clamp_eth3d`, and a stage-averaged confidence (ce and
mixup_ce; the last stage's for re and was). `CascadeMVSNet` holds that
cascade; each model supplies its features (`extract_features`), and
DINOMVSNet (`models/dino.py`) averages the confidences whatever the depth
type, as the JAX DINOMVSNet does. In eval with `eval_view_chunk` the
features are extracted over chunks of that many views, as the JAX
`extract_view_features` does. Inputs keep the JAX layout: images [B, V,
H, W, 3], projections {stageK: [B, V, 2, 4, 4]}, depth_values [B,
Dfull]. Inside, maps are NCHW.

The model's compute dtype (`build_model`'s `dtype`, fp32 by default) is the
JAX `build_model`'s `dtype`: in bf16 the images enter the FPN encoder and
(after the bicubic rescale, in fp32) the backbone in bf16, and every
convolution, matmul and activation follows them in bf16 with fp32
parameters, down to the features the stages read; the stages keep the
JAX package's fp32 islands (`models/stagenet.py`), and the confidences,
their average and every output are fp32. No autocast: the casts are
explicit in the modules (`models/blocks.py`), so the CPU runs the same
casts as the card.

The forward follows `self.training`, as the JAX model follows its
`training` argument: batch-statistics BN, stochastic depth in the backbone
(drawn from the caller's generator), and each stage's training warp and
decode. With `cfg.fix` the backbone runs without gradient and without drop
path, as the JAX model stops its gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from mvsformer_torch import fp32_math, resolve_device
from mvsformer_torch.config import ModelConfig
from mvsformer_torch.models.blocks import FoldedBatchNorm
from mvsformer_torch.models.decoders import TwinDecoderStage4
from mvsformer_torch.models.fpn import FPNDecoder, FPNEncoder
from mvsformer_torch.models.stagenet import StageNet
from mvsformer_torch.models.twins import PRESETS, build_twins
from mvsformer_torch.ops import hypotheses
from mvsformer_torch.ops.resize import resize_bicubic, resize_nearest

STAGE_SCALES = (8, 4, 2, 1)  # stage1..stage4 feature-map downscale factors
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class CascadeMVSNet(nn.Module):
    """The FPN and the StageNet cascade; a subclass adds its backbone and
    `extract_features(imgs [N, 3, H, W], generator) -> 4 per-stage maps`.
    `always_average`: the final confidence is the stages' mean for every
    depth type (else for ce and mixup_ce only, the last stage's for the
    rest)."""

    always_average = False

    def __init__(self, cfg: ModelConfig, dtype=torch.float32):
        super().__init__()
        self.layout = None
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute dtype {dtype}: one of {COMPUTE_DTYPES}")
        self.cfg = cfg
        self._bf16 = dtype == torch.bfloat16
        feat_chs = tuple(cfg.feat_chs)
        self.encoder = FPNEncoder(feat_chs, cfg.norm_type)
        self.decoder = FPNDecoder(feat_chs, cfg.norm_type)
        self.fusions = nn.ModuleList(
            StageNet(nd, cfg.base_ch, cfg.model_th, cfg.fusion_type, cfg.depth_type,
                     cfg.norm_type, cfg.attn_temp) for nd in cfg.ndepths)

    def use_layout(self, layout) -> None:
        """Run as one rank of `layout` (`parallel/mesh.Layout`; None runs
        alone): training BN synchronised over its data group, and each
        stage's view sums completed over its view group. The caller feeds
        the model this rank's samples and views (`Layout.local_views`).
        Parameters and buffers do not change, so a state dict moves freely
        between the two."""
        self.layout = layout
        for m in self.modules():
            if isinstance(m, FoldedBatchNorm):
                m.data_group = layout.data_group if layout else None
            elif isinstance(m, StageNet):
                m.view_group = layout.view_group if layout else None

    @property
    def compute_dtype(self) -> torch.dtype:
        """bf16 in the bf16 mode; otherwise the parameters' dtype (fp32, or
        float64 for a model made `.double()`)."""
        return torch.bfloat16 if self._bf16 else self.encoder.conv00.conv.weight.dtype

    def vit_input(self, imgs):
        """The images bicubically rescaled by `vit_args.rescale` in fp32,
        then in the compute dtype."""
        vit_h = int(imgs.shape[2] * self.cfg.vit_args.rescale)
        vit_w = int(imgs.shape[3] * self.cfg.vit_args.rescale)
        return resize_bicubic(imgs.float(), (vit_h, vit_w)).to(self.compute_dtype)

    def forward(self, imgs, proj_matrices, depth_values, tmp=2.0, generator=None):
        """imgs [B, V, H, W, 3]; proj_matrices {stageK: [B, V, 2, 4, 4]};
        depth_values [B, Dfull]; tmp: float or per-stage list (eval);
        generator: the torch.Generator that drop path draws from in training
        (on the model's device; None takes the default one).

        The fp32 work (all of it in fp32 mode; the islands in bf16 mode)
        runs in full fp32: TF32 is off for the forward and the caller's
        setting is restored. A training step also runs its backward under
        `fp32_math`."""
        with fp32_math():
            return self._forward(imgs, proj_matrices, depth_values, tmp, generator)

    def view_features(self, imgs, generator=None):
        """imgs [B, V, H, W, 3] -> per-stage maps [B, V, C, h, w]; in eval
        with 0 < `eval_view_chunk` < V, over chunks of that many views."""
        B, V, H, W, _ = imgs.shape
        chunk = self.cfg.eval_view_chunk
        if self.training or not 0 < chunk < V:
            chunk = V
        per_stage = None
        for v0 in range(0, V, chunk):
            cv = min(chunk, V - v0)
            flat = imgs[:, v0:v0 + cv].reshape(B * cv, H, W, 3).permute(0, 3, 1, 2).contiguous()
            fs = [f.reshape(B, cv, *f.shape[1:]) for f in self.extract_features(flat, generator)]
            per_stage = fs if per_stage is None else [
                torch.cat([a, b], dim=1) for a, b in zip(per_stage, fs)]
        return per_stage

    def _forward(self, imgs, proj_matrices, depth_values, tmp, generator=None):
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        features = self.view_features(imgs, generator)
        clamped = cfg.inverse_depth and cfg.clamp_eth3d

        outputs = {}
        prev = None
        # The stages' confidences are averaged for the ce decodes (for every
        # depth type in DINOMVSNet), as the JAX models do; otherwise the
        # final confidence is the last stage's.
        averaged = self.always_average or cfg.depth_type in ("ce", "mixup_ce")
        conf_sum = torch.zeros((B, H, W), dtype=torch.float32, device=imgs.device)
        depth_interval = depth_values[:, 1] - depth_values[:, 0]
        for stage_idx, ndepth in enumerate(cfg.ndepths):
            feat = features[stage_idx]
            sh, sw = feat.shape[3], feat.shape[4]
            projs = proj_matrices[f"stage{stage_idx + 1}"]
            if stage_idx == 0:
                init = (hypotheses.init_inverse_range_clamped if clamped
                        else hypotheses.init_inverse_range if cfg.inverse_depth
                        else hypotheses.init_range)
                samples = init(depth_values, ndepth, sh, sw)
            elif cfg.inverse_depth:
                samples = hypotheses.schedule_inverse_range(
                    prev["depth"].detach(), prev["depth_values"], ndepth,
                    cfg.depth_interals_ratio[stage_idx], sh, sw,
                    inv_floor=hypotheses.ETH3D_INV_FLOOR if clamped else None)
            else:
                samples = hypotheses.schedule_range(
                    prev["depth"].detach(), ndepth,
                    cfg.depth_interals_ratio[stage_idx] * depth_interval, sh, sw)
            stage_tmp = tmp[stage_idx] if isinstance(tmp, (list, tuple)) else tmp
            prev = self.fusions[stage_idx](feat[:, 0], feat[:, 1:], projs[:, 0],
                                           projs[:, 1:], samples, stage_tmp)
            outputs[f"stage{stage_idx + 1}"] = prev
            if averaged:
                conf = prev["photometric_confidence"]
                if conf.shape[1:] != (H, W):
                    conf = resize_nearest(conf, (H, W))
                conf_sum = conf_sum + conf
        outputs["refined_depth"] = prev["depth"]
        outputs["photometric_confidence"] = (conf_sum / len(cfg.ndepths) if averaged
                                             else prev["photometric_confidence"])
        return outputs


class TwinMVSNet(CascadeMVSNet):
    def __init__(self, cfg: ModelConfig, dtype=torch.float32, layout=None):
        super().__init__(cfg, dtype)
        self.vit = build_twins(cfg.vit_args.vit_arch, cfg.vit_args.drop_path_rate)
        self.decoder_vit = TwinDecoderStage4(PRESETS[cfg.vit_args.vit_arch]["embed_dims"],
                                             cfg.vit_args.out_ch, cfg.norm_type)
        self.use_layout(layout)

    def extract_features(self, imgs, generator=None):
        """imgs [N, 3, H, W] -> per-stage maps (stage1..4 at 1/8..1/1), in
        the compute dtype."""
        conv01, conv11, conv21, conv31 = self.encoder(imgs.to(self.compute_dtype))
        vit_imgs = self.vit_input(imgs)
        if self.training and self.cfg.fix:
            with torch.no_grad():
                vit_feats = self.vit(vit_imgs, deterministic=True)
        else:
            vit_feats = self.vit(vit_imgs, generator=generator)
        conv31 = conv31 + self.decoder_vit(*vit_feats)
        return self.decoder(conv01, conv11, conv21, conv31)


DEPTH_TYPES = ("ce", "re", "was", "mixup_ce")


def build_model(cfg: ModelConfig, device=None, train: bool = False,
                dtype=torch.float32, layout=None) -> CascadeMVSNet:
    """TwinMVSNet (`model_type` "twin") or DINOMVSNet ("dino") on `device`
    (`cuda` unless the caller asks for the CPU; raises if CUDA is asked for
    and absent), in eval mode, or in training mode with `train=True`, with
    fp32 parameters computing in `dtype`: torch.float32 or torch.bfloat16
    (the JAX package's bf16 mode, with its fp32 islands), as one rank of
    `layout` (`parallel/mesh.Layout`, the JAX `build_model`'s `axis_name`
    and `view_axis`; None runs alone). Raises NotImplementedError for parts
    of the configuration that later slices port, ValueError for values no
    model has."""
    dev = resolve_device(device)
    va, dino = cfg.vit_args, cfg.model_type == "dino"
    unsupported = {
        "multi_scale (ROADMAP A6)": bool(cfg.multi_scale),
        "att_fusion=false (ROADMAP A6)": dino and not va.att_fusion,
        "cross_att (ROADMAP A6)": dino and bool(va.cross_att),
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    if cfg.model_type not in ("twin", "dino"):
        raise ValueError(f"unknown model_type {cfg.model_type!r}")
    if cfg.depth_type not in DEPTH_TYPES:
        raise ValueError(f"unknown depth_type {cfg.depth_type!r}; one of {DEPTH_TYPES}")
    if dino:
        from mvsformer_torch.models.dino import DINOMVSNet

        return DINOMVSNet(cfg, dtype, layout).to(dev).train(train)
    return TwinMVSNet(cfg, dtype, layout).to(dev).train(train)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every weight from `generator` (a CPU generator, so the draw does
    not depend on the device): convs and linears ~ N(0, 1/fan_in), biases and
    norm shifts ~ 0.05 N(0, 1), the scales of layer, group and batch norms
    ~ 1 + 0.1 N(0, 1), BN running stats non-trivial (mean 0.1 N(0, 1), var
    1 + 0.2 |N(0, 1)|), and a ViT's bare parameters (`cls_token`,
    `pos_embed`) ~ 0.02 N(0, 1)."""
    def draw(t, std, mean=0.0, absolute=False):
        x = torch.randn(t.shape, generator=generator)
        x = x.abs() if absolute else x
        t.copy_((x * std + mean).to(t.device, t.dtype))

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear,
                            nn.ConvTranspose2d, nn.ConvTranspose3d)):
            w = mod.weight
            if isinstance(mod, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
                fan_in = w.shape[0] * math.prod(w.shape[2:]) // math.prod(mod.stride)
            else:
                fan_in = math.prod(w.shape[1:])
            draw(w, fan_in ** -0.5)
            if mod.bias is not None:
                draw(mod.bias, 0.05)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)):
            draw(mod.weight, 0.1, 1.0)
            draw(mod.bias, 0.05)
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                draw(mod.running_mean, 0.1)
                draw(mod.running_var, 0.2, 1.0, absolute=True)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("cls_token", "pos_embed"):
            draw(p, 0.02)
    return model
