"""3D cost-volume regularisation U-Nets over [B, G, D, H, W] volumes.

Port of `CostRegNet`, `CostRegNet3D` and `CostRegNet2D` from
`mvsformer_tpu/models/costreg.py`, as plain `Conv3d` and `ConvTranspose3d`
(the JAX package's depth-packed form is an exact TPU rewrite of the same
convs). Each takes the model's `norm_type`.

Each forward calls its blocks through `run(block, x)`: the block itself by
default, or `parallel/depth.DepthSlabs.run` over a slab of the depth axis,
where x and the skips are `parallel/depth.Slab`s (the same graph, with the
halo exchange around each conv).
"""

from __future__ import annotations

import torch.nn as nn

from mvsformer_torch.models.blocks import (Conv3d, Conv3dNormAct, Deconv2dIn3dSeq,
                                           Deconv3dNormAct, Deconv3dSeq)


def call(block, x):
    return block(x)


class CostRegNet(nn.Module):
    """Full 3D U-Net, stride 2 in (D, H, W); D must divide by 8."""

    def __init__(self, in_ch=8, base_ch=8, last_layer=True, norm="BN"):
        super().__init__()
        c = base_ch
        self.conv1 = Conv3dNormAct(in_ch, c * 2, stride=2, norm=norm)
        self.conv2 = Conv3dNormAct(c * 2, c * 2, norm=norm)
        self.conv3 = Conv3dNormAct(c * 2, c * 4, stride=2, norm=norm)
        self.conv4 = Conv3dNormAct(c * 4, c * 4, norm=norm)
        self.conv5 = Conv3dNormAct(c * 4, c * 8, stride=2, norm=norm)
        self.conv6 = Conv3dNormAct(c * 8, c * 8, norm=norm)
        self.conv7 = Deconv3dNormAct(c * 8, c * 4, stride=2, norm=norm)
        self.conv9 = Deconv3dNormAct(c * 4, c * 2, stride=2, norm=norm)
        self.conv11 = Deconv3dNormAct(c * 2, c, stride=2, norm=norm)
        self.inner = Conv3d(in_ch, c, 1) if in_ch != c else None
        self.prob = Conv3d(c, 1, 3, 1, 1, bias=False) if last_layer else None

    def forward(self, x, run=call):
        conv2 = run(self.conv2, run(self.conv1, x))
        conv4 = run(self.conv4, run(self.conv3, conv2))
        bott = run(self.conv6, run(self.conv5, conv4))
        up = conv4 + run(self.conv7, bott)
        up = conv2 + run(self.conv9, up)
        inner = run(self.inner, x) if self.inner is not None else x
        up = inner + run(self.conv11, up)
        return run(self.prob, up) if self.prob is not None else up


class CostRegNet3D(nn.Module):
    """Spatial-stride-only 3D U-Net (keeps the full depth axis)."""

    def __init__(self, in_ch=8, base_ch=8, norm="BN"):
        super().__init__()
        c = base_ch
        s = (1, 2, 2)
        self.conv1 = Conv3dNormAct(in_ch, c * 2, stride=s, norm=norm)
        self.conv2 = Conv3dNormAct(c * 2, c * 2, norm=norm)
        self.conv3 = Conv3dNormAct(c * 2, c * 4, stride=s, norm=norm)
        self.conv4 = Conv3dNormAct(c * 4, c * 4, norm=norm)
        self.conv5 = Conv3dNormAct(c * 4, c * 8, stride=s, norm=norm)
        self.conv6 = Conv3dNormAct(c * 8, c * 8, norm=norm)
        self.conv7 = Deconv3dSeq(c * 8, c * 4, s, norm=norm)
        self.conv9 = Deconv3dSeq(c * 4, c * 2, s, norm=norm)
        self.conv11 = Deconv3dSeq(c * 2, c, s, norm=norm)
        self.inner = Conv3d(in_ch, c, 1) if in_ch != c else None
        self.prob = Conv3d(c, 1, 1)

    def forward(self, x, run=call):
        conv2 = run(self.conv2, run(self.conv1, x))
        conv4 = run(self.conv4, run(self.conv3, conv2))
        bott = run(self.conv6, run(self.conv5, conv4))
        up = conv4 + run(self.conv7, bott)
        up = conv2 + run(self.conv9, up)
        inner = run(self.inner, x) if self.inner is not None else x
        up = inner + run(self.conv11, up)
        return run(self.prob, up)


class CostRegNet2D(nn.Module):
    """The epipole fusion's U-Net: its strided convs and transposed convs
    have (1, 3, 3) kernels, so depth planes are down- and upsampled each on
    its own; conv2/4/6 are full 3x3x3 convs. The input has `base_ch`
    channels (the correlation groups), so the skip at full size is the
    input itself."""

    def __init__(self, base_ch=8, norm="BN"):
        super().__init__()
        c = base_ch
        k, s = (1, 3, 3), (1, 2, 2)
        self.conv1 = Conv3dNormAct(c, c * 2, k, s, norm=norm)
        self.conv2 = Conv3dNormAct(c * 2, c * 2, norm=norm)
        self.conv3 = Conv3dNormAct(c * 2, c * 4, k, s, norm=norm)
        self.conv4 = Conv3dNormAct(c * 4, c * 4, norm=norm)
        self.conv5 = Conv3dNormAct(c * 4, c * 8, k, s, norm=norm)
        self.conv6 = Conv3dNormAct(c * 8, c * 8, norm=norm)
        self.conv7 = Deconv2dIn3dSeq(c * 8, c * 4, norm=norm)
        self.conv9 = Deconv2dIn3dSeq(c * 4, c * 2, norm=norm)
        self.conv11 = Deconv2dIn3dSeq(c * 2, c, norm=norm)
        self.prob = Conv3d(c, 1, 1)

    def forward(self, x, run=call):
        conv2 = run(self.conv2, run(self.conv1, x))
        conv4 = run(self.conv4, run(self.conv3, conv2))
        bott = run(self.conv6, run(self.conv5, conv4))
        up = conv4 + run(self.conv7, bott)
        up = conv2 + run(self.conv9, up)
        up = x + run(self.conv11, up)
        return run(self.prob, up)
