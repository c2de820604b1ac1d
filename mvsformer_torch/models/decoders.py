"""ViT-to-FPN decoder head (NCHW).

Port of `TwinDecoderStage4` from `mvsformer_tpu/models/decoders.py`: the
Twins pyramid (1/8..1/64 of the image) fused top-down into one 1/8-res map.
The multi-scale and DINO decoders come with later slices.
"""

from __future__ import annotations

import torch.nn as nn

from mvsformer_torch.models.blocks import ConvNormSeq, Deconv2dNormAct, Swish, gelu_tanh
from mvsformer_torch.ops.resize import resize_bilinear


def _up2(x):
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2), align_corners=False)


class TwinDecoderStage4(nn.Module):
    def __init__(self, vit_chs=(64, 128, 256, 512), out_ch=64):
        super().__init__()
        ch = out_ch * 4
        self.upsampler0 = Deconv2dNormAct(vit_chs[3], ch, gelu_tanh())
        self.inner1 = nn.Conv2d(vit_chs[2], ch, 1)
        self.smooth1 = ConvNormSeq(ch, ch // 2, 3, nn.ReLU())
        self.inner2 = nn.Conv2d(vit_chs[1], ch // 2, 1)
        self.smooth2 = ConvNormSeq(ch // 2, ch // 4, 3, nn.ReLU())
        self.inner3 = nn.Conv2d(vit_chs[0], ch // 4, 1)
        self.smooth3 = ConvNormSeq(ch // 4, ch // 4, 3, Swish())

    def forward(self, x1, x2, x3, x4):
        x = self.upsampler0(x4) + self.inner1(x3)
        x = self.smooth1(x)
        x = _up2(x) + self.inner2(x2)
        x = self.smooth2(x)
        x = _up2(x) + self.inner3(x1)
        return self.smooth3(x)
