"""ViT-to-FPN decoder heads (NCHW).

Port of `mvsformer_tpu/models/decoders.py`: `TwinDecoderStage4` fuses the
Twins pyramid (1/8..1/64 of the image) top-down into one 1/8-res map;
`VITDecoderStage4Single` gates the DINO ViT's 1/32-res tokens by the last
block's CLS attention (`AttentionFusionSimple`) and upsamples them 4x to
one 1/8-res map. The DINO decoder without the attention fusion and the
multi-scale decoders come with a later slice (ROADMAP A6).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import (Conv2d, ConvNormSeq, Deconv2dNormAct, Swish,
                                           gelu_tanh)
from mvsformer_torch.ops.resize import resize_bilinear


def _up2(x):
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=False)


class TwinDecoderStage4(nn.Module):
    def __init__(self, vit_chs=(64, 128, 256, 512), out_ch=64, norm="BN"):
        super().__init__()
        ch = out_ch * 4
        self.upsampler0 = Deconv2dNormAct(vit_chs[3], ch, gelu_tanh(), norm=norm)
        self.inner1 = Conv2d(vit_chs[2], ch, 1)
        self.smooth1 = ConvNormSeq(ch, ch // 2, 3, nn.ReLU(), norm=norm)
        self.inner2 = Conv2d(vit_chs[1], ch // 2, 1)
        self.smooth2 = ConvNormSeq(ch // 2, ch // 4, 3, nn.ReLU(), norm=norm)
        self.inner3 = Conv2d(vit_chs[0], ch // 4, 1)
        self.smooth3 = ConvNormSeq(ch // 4, ch // 4, 3, Swish(), norm=norm)

    def forward(self, x1, x2, x3, x4):
        x = self.upsampler0(x4) + self.inner1(x3)
        x = self.smooth1(x)
        x = _up2(x) + self.inner2(x2)
        x = self.smooth2(x)
        x = _up2(x) + self.inner3(x1)
        return self.smooth3(x)


class AttentionFusionSimple(nn.Module):
    """CLS-attention gating of ViT features: proj(conv_l([x, att]) *
    conv_r(x * mean_heads(att))), each conv a 3x3 conv + BN + swish.
    x [N, embed_dim, h, w], att [N, heads, h, w]."""

    def __init__(self, embed_dim, heads, vit_ch, out_ch, norm="BN"):
        super().__init__()
        self.conv_l = ConvNormSeq(embed_dim + heads, vit_ch, 3, Swish(), norm=norm)
        self.conv_r = ConvNormSeq(embed_dim, vit_ch, 3, Swish(), norm=norm)
        self.proj = Conv2d(vit_ch, out_ch, 1)

    def forward(self, x, att):
        x1 = self.conv_l(torch.cat([x, att], dim=1))
        x2 = self.conv_r(x * att.mean(dim=1, keepdim=True))
        return self.proj(x1 * x2)


class VITDecoderStage4Single(nn.Module):
    """DINO tokens [N, embed_dim, h, w] and CLS attention -> one map of
    `out_ch` channels at 4x the token grid. The two transposed convs sit in
    one `Sequential` (reference keys `decoder.0/1` and `decoder.3/4`)."""

    def __init__(self, embed_dim, heads, vit_ch=384, out_ch=64, norm="BN"):
        super().__init__()
        self.attn = AttentionFusionSimple(embed_dim, heads, vit_ch, out_ch * 4, norm)
        self.decoder = nn.Sequential(
            *Deconv2dNormAct(out_ch * 4, out_ch * 2, gelu_tanh(), norm=norm),
            *Deconv2dNormAct(out_ch * 2, out_ch, gelu_tanh(), norm=norm))

    def forward(self, x, att):
        return self.decoder(self.attn(x, att))
