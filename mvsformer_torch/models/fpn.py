"""FPN feature encoder and top-down decoder (NCHW).

Port of `mvsformer_tpu/models/fpn.py` at the JAX package's default flags
(`fused_enc_head`, `fused_fpn_final`, `fused_fpn_l2`): the encoder head
(conv00, conv01, downsample1) is K4 `encoder_head`, and each of the three
top-down levels is K5 `fpn_level`. Levels 1 and 2 hand their intra' map to
the next level; the final level does not emit it, so on the card the
full-resolution 64-channel intra' never exists. On the CPU both run their
plain versions, which are the same convolutions and resizes.
"""

from __future__ import annotations

import torch.nn as nn

from mvsformer_torch.models.blocks import ConvNormAct, ConvNormSeq, Swish
from mvsformer_torch.ops.encoder_head import encoder_head
from mvsformer_torch.ops.fpn_level import fpn_level


class FPNEncoder(nn.Module):
    def __init__(self, feat_chs=(8, 16, 32, 64)):
        super().__init__()
        ch = feat_chs
        self.conv00 = ConvNormAct(3, ch[0], 7)
        self.conv01 = ConvNormAct(ch[0], ch[0], 5)
        self.downsample1 = ConvNormAct(ch[0], ch[1], 5, stride=2)
        self.conv10 = ConvNormAct(ch[1], ch[1])
        self.conv11 = ConvNormAct(ch[1], ch[1])
        self.downsample2 = ConvNormAct(ch[1], ch[2], 5, stride=2)
        self.conv20 = ConvNormAct(ch[2], ch[2])
        self.conv21 = ConvNormAct(ch[2], ch[2])
        self.downsample3 = ConvNormAct(ch[2], ch[3], 3, stride=2)
        self.conv30 = ConvNormAct(ch[3], ch[3])
        self.conv31 = ConvNormAct(ch[3], ch[3])

    def forward(self, x):
        conv01, down0 = encoder_head(
            x, self.conv00.conv.weight, self.conv00.bn.folded(),
            self.conv01.conv.weight, self.conv01.bn.folded(),
            self.downsample1.conv.weight, self.downsample1.bn.folded())
        conv11 = self.conv11(self.conv10(down0))
        conv21 = self.conv21(self.conv20(self.downsample2(conv11)))
        conv31 = self.conv31(self.conv30(self.downsample3(conv21)))
        return conv01, conv11, conv21, conv31


class FPNDecoder(nn.Module):
    """Top-down add decoder -> stage1..stage4 maps at 1/8..1/1 resolution."""

    def __init__(self, feat_chs=(8, 16, 32, 64)):
        super().__init__()
        ch = feat_chs
        final = ch[-1]
        self.out0 = ConvNormSeq(ch[3], ch[3], 1, Swish())
        self.inner1 = nn.Conv2d(ch[2], final, 1)
        self.out1 = ConvNormSeq(final, ch[2], 3, Swish())
        self.inner2 = nn.Conv2d(ch[1], final, 1)
        self.out2 = ConvNormSeq(final, ch[1], 3, Swish())
        self.inner3 = nn.Conv2d(ch[0], final, 1)
        self.out3 = ConvNormSeq(final, ch[0], 3, Swish())

    def _level(self, i, intra, lateral, emit_intra):
        inner, out = getattr(self, f"inner{i}"), getattr(self, f"out{i}")
        return fpn_level(intra, lateral, inner.weight, inner.bias, out[0].weight,
                         out[0].bias, out[1].folded(), emit_intra=emit_intra)

    def forward(self, conv01, conv11, conv21, conv31):
        out0 = self.out0(conv31)
        out1, intra = self._level(1, conv31, conv21, True)
        out2, intra = self._level(2, intra, conv11, True)
        out3 = self._level(3, intra, conv01, False)
        return out0, out1, out2, out3
