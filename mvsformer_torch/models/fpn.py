"""FPN feature encoder and top-down decoder (NCHW).

Port of `mvsformer_tpu/models/fpn.py` at the JAX package's default flags
(`fused_enc_head`, `fused_fpn_final`, `fused_fpn_l2`): the encoder head
(conv00, conv01, downsample1) is K4 `encoder_head`, and each of the three
top-down levels is K5 `fpn_level`. Levels 1 and 2 hand their intra' map to
the next level; the final level does not emit it, so on the card the
full-resolution 64-channel intra' never exists. On the CPU both run their
plain versions, which are the same convolutions and resizes.

K4 and K5 take folded (running-stat) BN and have no backward, so they run
in eval under `norm_type="BN"` only, as the JAX package gates its kernels
on `not training and norm == "BN"`. In training, and under GN, IN or no
norm, the head and the levels run as the modules themselves: convs, the
norm, the align-corners 2x resize and the 1x1 inner convs. The choice is
made once, when the module is built, from the norm.

Under `multi_scale` the decoder is `FPNDecoderV2`, which fuses the three
maps of the multi-scale ViT decoders by concatenation and upsamples with
transposed convs: its levels are the modules themselves (cuDNN), in eval
as in training, as the JAX package has no kernel for them. The encoder
head stays K4 in eval under BN (the JAX package turns its fused head off
under `multi_scale`, a TPU routing choice over the same maths).

In the bf16 mode K4 and K5 are fp32 islands: they take the bf16 maps and
the weights in bf16, as a bf16 convolution reads them, compute in fp32
and return bf16 (`ops/cuda_build.fp32_island`); the folded BN stays fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mvsformer_torch.models.blocks import (Conv2d, ConvNormAct, ConvNormSeq, Deconv2dNormAct,
                                           Swish, like)
from mvsformer_torch.ops.encoder_head import encoder_head
from mvsformer_torch.ops.fpn_level import fpn_level
from mvsformer_torch.ops.resize import resize_bilinear


class FPNEncoder(nn.Module):
    def __init__(self, feat_chs=(8, 16, 32, 64), norm="BN"):
        super().__init__()
        ch = feat_chs
        self.kernel = norm == "BN"  # K4 runs the head in eval
        kw = dict(norm=norm)
        self.conv00 = ConvNormAct(3, ch[0], 7, **kw)
        self.conv01 = ConvNormAct(ch[0], ch[0], 5, **kw)
        self.downsample1 = ConvNormAct(ch[0], ch[1], 5, stride=2, **kw)
        self.conv10 = ConvNormAct(ch[1], ch[1], **kw)
        self.conv11 = ConvNormAct(ch[1], ch[1], **kw)
        self.downsample2 = ConvNormAct(ch[1], ch[2], 5, stride=2, **kw)
        self.conv20 = ConvNormAct(ch[2], ch[2], **kw)
        self.conv21 = ConvNormAct(ch[2], ch[2], **kw)
        self.downsample3 = ConvNormAct(ch[2], ch[3], 3, stride=2, **kw)
        self.conv30 = ConvNormAct(ch[3], ch[3], **kw)
        self.conv31 = ConvNormAct(ch[3], ch[3], **kw)

    def forward(self, x):
        if self.training or not self.kernel:
            conv01 = self.conv01(self.conv00(x))
            down0 = self.downsample1(conv01)
        else:
            conv01, down0 = encoder_head(
                x, like(self.conv00.conv.weight, x), self.conv00.bn.folded(),
                like(self.conv01.conv.weight, x), self.conv01.bn.folded(),
                like(self.downsample1.conv.weight, x), self.downsample1.bn.folded())
        conv11 = self.conv11(self.conv10(down0))
        conv21 = self.conv21(self.conv20(self.downsample2(conv11)))
        conv31 = self.conv31(self.conv30(self.downsample3(conv21)))
        return conv01, conv11, conv21, conv31


class FPNDecoder(nn.Module):
    """Top-down add decoder -> stage1..stage4 maps at 1/8..1/1 resolution."""

    def __init__(self, feat_chs=(8, 16, 32, 64), norm="BN"):
        super().__init__()
        ch = feat_chs
        final = ch[-1]
        self.kernel = norm == "BN"  # K5 runs each level in eval
        self.out0 = ConvNormSeq(ch[3], ch[3], 1, Swish(), norm=norm)
        self.inner1 = Conv2d(ch[2], final, 1)
        self.out1 = ConvNormSeq(final, ch[2], 3, Swish(), norm=norm)
        self.inner2 = Conv2d(ch[1], final, 1)
        self.out2 = ConvNormSeq(final, ch[1], 3, Swish(), norm=norm)
        self.inner3 = Conv2d(ch[0], final, 1)
        self.out3 = ConvNormSeq(final, ch[0], 3, Swish(), norm=norm)

    def _level(self, i, intra, lateral, emit_intra):
        inner, out = getattr(self, f"inner{i}"), getattr(self, f"out{i}")
        if self.training or not self.kernel:
            h, w = intra.shape[-2:]
            intra = resize_bilinear(intra, (2 * h, 2 * w), align_corners=True) + inner(lateral)
            return (out(intra), intra) if emit_intra else out(intra)
        return fpn_level(intra, lateral, *(like(t, intra) for t in (
            inner.weight, inner.bias, out[0].weight, out[0].bias)), out[1].folded(),
            emit_intra=emit_intra)

    def forward(self, conv01, conv11, conv21, conv31):
        out0 = self.out0(conv31)
        out1, intra = self._level(1, conv31, conv21, True)
        out2, intra = self._level(2, intra, conv11, True)
        out3 = self._level(3, intra, conv01, False)
        return out0, out1, out2, out3


class FPNDecoderV2(nn.Module):
    """The multi-scale decoder: each level a 3x3 conv + norm + swish
    (`outK`, reference keys `0`/`1`) on the concatenation of the encoder's
    map (plus the upsampled level above) and the ViT decoder's map of that
    resolution, `upsampleK` a transposed conv + norm + ReLU; the last level
    takes `upsample3` + conv01 alone. `vit_chs`: the channels of the three
    ViT maps (out_ch, out_ch / 2, out_ch / 4 of either multi-scale ViT
    decoder). -> stage1..stage4 maps at 1/8..1/1 resolution."""

    def __init__(self, feat_chs=(8, 16, 32, 64), vit_chs=(64, 32, 16), norm="BN"):
        super().__init__()
        ch = feat_chs
        self.out1 = ConvNormSeq(ch[3] + vit_chs[0], ch[3], 3, Swish(), norm=norm)
        self.upsample1 = Deconv2dNormAct(ch[3], ch[2], nn.ReLU(), norm=norm)
        self.out2 = ConvNormSeq(ch[2] + vit_chs[1], ch[2], 3, Swish(), norm=norm)
        self.upsample2 = Deconv2dNormAct(ch[2], ch[1], nn.ReLU(), norm=norm)
        self.out3 = ConvNormSeq(ch[1] + vit_chs[2], ch[1], 3, Swish(), norm=norm)
        self.upsample3 = Deconv2dNormAct(ch[1], ch[0], nn.ReLU(), norm=norm)
        self.out4 = ConvNormSeq(ch[0], ch[0], 3, Swish(), norm=norm)

    def forward(self, conv01, conv11, conv21, conv31, vit1, vit2, vit3):
        out1 = self.out1(torch.cat([conv31, vit1], dim=1))
        out2 = self.out2(torch.cat([self.upsample1(out1) + conv21, vit2], dim=1))
        out3 = self.out3(torch.cat([self.upsample2(out2) + conv11, vit3], dim=1))
        return out1, out2, out3, self.out4(self.upsample3(out3) + conv01)
