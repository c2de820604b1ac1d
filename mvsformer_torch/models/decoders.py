"""ViT-to-FPN decoder heads (NCHW).

Port of `mvsformer_tpu/models/decoders.py`: `TwinDecoderStage4` fuses the
Twins pyramid (1/8..1/64 of the image) top-down into one 1/8-res map;
`VITDecoderStage4Single` gates the DINO ViT's 1/32-res tokens by the last
block's CLS attention (`AttentionFusionSimple`) and upsamples them 4x to
one 1/8-res map; `VITDecoderStage4NoAtt` does the same without the gating.
Under `multi_scale` `TwinDecoderStage4V2` and `VITDecoderStage4` return
maps at 1/8, 1/4 and 1/2 of the image, which `fpn.FPNDecoderV2`
concatenates into its levels.

The Twins decoders carry the reference checkpoint's names (the keys
`convert_full_twin` reads). The reference names of `VITDecoderStage4` and
`VITDecoderStage4NoAtt` are not in the repository (`convert_full_dino`
maps neither), so their attributes are the flax modules' names; a
reference checkpoint of these two variants cannot be mapped by name until
such names are in the repository.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import (Conv2d, ConvNormSeq, ConvTranspose2d,
                                           Deconv2dNormAct, Swish, gelu_tanh, make_norm)
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


class TwinDecoderStage4V2(nn.Module):
    """The multi-scale Twins decoder: `TwinDecoderStage4` with GELU in its
    three smooth blocks, then `decoder1` and `decoder2` (transposed convs
    down to ch/8 and ch/16 channels, ch = 4 out_ch); returns the 1/8, 1/4
    and 1/2-res maps."""

    def __init__(self, vit_chs=(64, 128, 256, 512), out_ch=64, norm="BN"):
        super().__init__()
        ch = out_ch * 4
        self.upsampler0 = Deconv2dNormAct(vit_chs[3], ch, gelu_tanh(), norm=norm)
        self.inner1 = Conv2d(vit_chs[2], ch, 1)
        self.smooth1 = ConvNormSeq(ch, ch // 2, 3, gelu_tanh(), norm=norm)
        self.inner2 = Conv2d(vit_chs[1], ch // 2, 1)
        self.smooth2 = ConvNormSeq(ch // 2, ch // 4, 3, gelu_tanh(), norm=norm)
        self.inner3 = Conv2d(vit_chs[0], ch // 4, 1)
        self.smooth3 = ConvNormSeq(ch // 4, ch // 4, 3, gelu_tanh(), norm=norm)
        self.decoder1 = Deconv2dNormAct(ch // 4, ch // 8, gelu_tanh(), norm=norm)
        self.decoder2 = Deconv2dNormAct(ch // 8, ch // 16, gelu_tanh(), norm=norm)

    def forward(self, x1, x2, x3, x4):
        x = self.smooth1(self.upsampler0(x4) + self.inner1(x3))
        x = self.smooth2(_up2(x) + self.inner2(x2))
        out1 = self.smooth3(_up2(x) + self.inner3(x1))
        out2 = self.decoder1(out1)
        return out1, out2, self.decoder2(out2)


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


class VITDecoderStage4(nn.Module):
    """The multi-scale DINO decoder: the attention fusion, `decoder1a` (a
    transposed conv + norm + GELU to 2 out_ch channels at 2x the token
    grid), then the plain transposed convs `decoder1b`, `decoder2` and
    `decoder3` (4x4, stride 2, with bias; flax's `ConvTranspose` with
    "SAME" padding pads the dilated input by 2 on each side, as torch's
    padding 1 does), the norms `bn2` and `bn3` and GELU between them.
    Returns maps of out_ch, out_ch/2 and out_ch/4 channels at 4x, 8x and
    16x the token grid (1/8, 1/4 and 1/2 of the image)."""

    def __init__(self, embed_dim, heads, vit_ch=384, out_ch=64, norm="BN"):
        super().__init__()
        ch = out_ch
        self.attn = AttentionFusionSimple(embed_dim, heads, vit_ch, ch * 4, norm)
        self.decoder1a = Deconv2dNormAct(ch * 4, ch * 2, gelu_tanh(), norm=norm)
        self.decoder1b = ConvTranspose2d(ch * 2, ch, 4, 2, 1)
        self.bn2 = make_norm(norm, ch)
        self.decoder2 = ConvTranspose2d(ch, ch // 2, 4, 2, 1)
        self.bn3 = make_norm(norm, ch // 2)
        self.decoder3 = ConvTranspose2d(ch // 2, ch // 4, 4, 2, 1)
        self.act = gelu_tanh()

    def forward(self, x, att):
        out1 = self.decoder1b(self.decoder1a(self.attn(x, att)))
        out2 = self.decoder2(self.act(self.bn2(out1)))
        return out1, out2, self.decoder3(self.act(self.bn3(out2)))


class VITDecoderStage4NoAtt(nn.Module):
    """The DINO decoder without the attention fusion: `down_sample` (a 3x3
    conv + norm + GELU to 4 out_ch channels), then `deconv1` and `deconv2`
    (transposed conv + norm + GELU) to one map of out_ch channels at 4x
    the token grid. The CLS attention is not read."""

    def __init__(self, embed_dim, out_ch=64, norm="BN"):
        super().__init__()
        self.down_sample = ConvNormSeq(embed_dim, out_ch * 4, 3, gelu_tanh(), norm=norm)
        self.deconv1 = Deconv2dNormAct(out_ch * 4, out_ch * 2, gelu_tanh(), norm=norm)
        self.deconv2 = Deconv2dNormAct(out_ch * 2, out_ch, gelu_tanh(), norm=norm)

    def forward(self, x, att=None):
        return self.deconv2(self.deconv1(self.down_sample(x)))
