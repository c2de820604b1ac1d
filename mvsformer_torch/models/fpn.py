"""FPN feature encoder and top-down decoder (NCHW).

Port of `mvsformer_tpu/models/fpn.py`, plain path: the encoder head and the
FPN levels as convolutions. Their hand-written kernels come with the next
slice.
"""

from __future__ import annotations

import torch.nn as nn

from mvsformer_torch.models.blocks import ConvNormAct, ConvNormSeq, Swish
from mvsformer_torch.ops.resize import resize_bilinear


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
        conv01 = self.conv01(self.conv00(x))
        conv11 = self.conv11(self.conv10(self.downsample1(conv01)))
        conv21 = self.conv21(self.conv20(self.downsample2(conv11)))
        conv31 = self.conv31(self.conv30(self.downsample3(conv21)))
        return conv01, conv11, conv21, conv31


def _up2(x):
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=True)


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

    def forward(self, conv01, conv11, conv21, conv31):
        intra = conv31
        out0 = self.out0(intra)
        intra = _up2(intra) + self.inner1(conv21)
        out1 = self.out1(intra)
        intra = _up2(intra) + self.inner2(conv11)
        out2 = self.out2(intra)
        intra = _up2(intra) + self.inner3(conv01)
        out3 = self.out3(intra)
        return out0, out1, out2, out3
