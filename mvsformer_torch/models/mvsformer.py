"""TwinMVSNet (MVSFormer), its eval and training forwards, and its factory.

Port of `mvsformer_tpu/models/mvsformer.py`: FPN encoder + Twins backbone
fused by TwinDecoderStage4, then a 4-stage coarse-to-fine cascade of
StageNets with inverse-depth (or metric) hypothesis scheduling and a
stage-averaged confidence (ce; the last stage's for was). Inputs keep the
JAX layout: images [B, V, H, W, 3], projections {stageK: [B, V, 2, 4, 4]},
depth_values [B, Dfull]. Inside, maps are NCHW.

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
from mvsformer_torch.models.decoders import TwinDecoderStage4
from mvsformer_torch.models.fpn import FPNDecoder, FPNEncoder
from mvsformer_torch.models.stagenet import StageNet
from mvsformer_torch.models.twins import PRESETS, build_twins
from mvsformer_torch.ops import hypotheses
from mvsformer_torch.ops.resize import resize_bicubic, resize_nearest

STAGE_SCALES = (8, 4, 2, 1)  # stage1..stage4 feature-map downscale factors


class TwinMVSNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        feat_chs = tuple(cfg.feat_chs)
        self.encoder = FPNEncoder(feat_chs)
        self.decoder = FPNDecoder(feat_chs)
        self.vit = build_twins(cfg.vit_args.vit_arch, cfg.vit_args.drop_path_rate)
        self.decoder_vit = TwinDecoderStage4(PRESETS[cfg.vit_args.vit_arch]["embed_dims"],
                                             cfg.vit_args.out_ch)
        self.fusions = nn.ModuleList(
            StageNet(nd, cfg.base_ch, cfg.model_th) for nd in cfg.ndepths)

    def extract_features(self, imgs, generator=None):
        """imgs [N, 3, H, W] -> per-stage maps (stage1..4 at 1/8..1/1)."""
        conv01, conv11, conv21, conv31 = self.encoder(imgs)
        vit_h = int(imgs.shape[2] * self.cfg.vit_args.rescale)
        vit_w = int(imgs.shape[3] * self.cfg.vit_args.rescale)
        vit_imgs = resize_bicubic(imgs.float(), (vit_h, vit_w)).to(imgs.dtype)
        if self.training and self.cfg.fix:
            with torch.no_grad():
                vit_feats = self.vit(vit_imgs, deterministic=True)
        else:
            vit_feats = self.vit(vit_imgs, generator=generator)
        conv31 = conv31 + self.decoder_vit(*vit_feats)
        return self.decoder(conv01, conv11, conv21, conv31)

    def forward(self, imgs, proj_matrices, depth_values, tmp=2.0, generator=None):
        """imgs [B, V, H, W, 3]; proj_matrices {stageK: [B, V, 2, 4, 4]};
        depth_values [B, Dfull]; tmp: float or per-stage list (eval);
        generator: the torch.Generator that drop path draws from in training
        (on the model's device; None takes the default one).

        The model is fp32, so its convolutions and matmuls run in full fp32:
        TF32 is off for the forward and the caller's setting is restored.
        A training step also runs its backward under `fp32_math`."""
        with fp32_math():
            return self._forward(imgs, proj_matrices, depth_values, tmp, generator)

    def _forward(self, imgs, proj_matrices, depth_values, tmp, generator=None):
        cfg = self.cfg
        B, V, H, W, _ = imgs.shape
        flat = imgs.reshape(B * V, H, W, 3).permute(0, 3, 1, 2).contiguous()
        features = [f.reshape(B, V, *f.shape[1:])
                    for f in self.extract_features(flat, generator)]

        outputs = {}
        prev = None
        # The stages' confidences are averaged for the ce decodes, as the JAX
        # model does; other depth types return the last stage's.
        averaged = cfg.depth_type in ("ce", "mixup_ce")
        conf_sum = torch.zeros((B, H, W), dtype=torch.float32, device=imgs.device)
        depth_interval = depth_values[:, 1] - depth_values[:, 0]
        for stage_idx, ndepth in enumerate(cfg.ndepths):
            feat = features[stage_idx]
            sh, sw = feat.shape[3], feat.shape[4]
            projs = proj_matrices[f"stage{stage_idx + 1}"]
            if stage_idx == 0:
                init = hypotheses.init_inverse_range if cfg.inverse_depth else hypotheses.init_range
                samples = init(depth_values, ndepth, sh, sw)
            elif cfg.inverse_depth:
                samples = hypotheses.schedule_inverse_range(
                    prev["depth"].detach(), prev["depth_values"], ndepth,
                    cfg.depth_interals_ratio[stage_idx], sh, sw)
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


def build_model(cfg: ModelConfig, device=None, train: bool = False) -> TwinMVSNet:
    """The model on `device` (`cuda` unless the caller asks for the CPU;
    raises if CUDA is asked for and absent), in eval mode, or in training
    mode with `train=True`. Raises NotImplementedError for parts of the
    configuration that later slices port."""
    dev = resolve_device(device)
    unsupported = {
        "model_type": cfg.model_type != "twin",
        "multi_scale": bool(cfg.multi_scale),
        "fusion_type": cfg.fusion_type != "cnn",
        "depth_type": cfg.depth_type not in ("ce", "was"),
        "norm_type": cfg.norm_type != "BN",
        "clamp_eth3d": bool(cfg.clamp_eth3d),
        "eval_view_chunk": cfg.eval_view_chunk > 0,
    }
    missing = [k for k, bad in unsupported.items() if bad]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")
    return TwinMVSNet(cfg).to(dev).train(train)


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every weight from `generator` (a CPU generator, so the draw does
    not depend on the device): convs and linears ~ N(0, 1/fan_in), biases and
    norm shifts ~ 0.05 N(0, 1), norm scales ~ 1 + 0.1 N(0, 1), and BN running
    stats non-trivial (mean 0.1 N(0, 1), var 1 + 0.2 |N(0, 1)|)."""
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
        elif isinstance(mod, (nn.LayerNorm, nn.modules.batchnorm._BatchNorm)):
            draw(mod.weight, 0.1, 1.0)
            draw(mod.bias, 0.05)
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                draw(mod.running_mean, 0.1)
                draw(mod.running_var, 0.2, 1.0, absolute=True)
    return model
