"""Conv / norm / activation building blocks (NCHW and NCDHW).

Port of `mvsformer_tpu/models/blocks.py`. Convolutions use torch-convention
padding p = (k - 1) // 2; transposed convolutions use the reference's
padding and output_padding, so the outputs are exact 2x upsamples. Module
attribute names are the reference checkpoint's (`conv`/`bn`, or the
`Sequential` indices), which is what the weight bridge maps.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def swish(x):
    return x * torch.sigmoid(x)


class Swish(nn.Module):
    def forward(self, x):
        return swish(x)


def gelu_tanh():
    """GELU as the JAX package computes it (flax `nn.gelu` is the tanh form)."""
    return nn.GELU(approximate="tanh")


class FoldedBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm for 2D or 3D maps whose eval forward is one folded affine.

    y = x * (weight * rsqrt(var + eps)) + (bias - mean * weight * rsqrt(...)),
    folded in fp32 on the [C] vectors, as the JAX package's eval BN does.

    Training mode normalises with the batch statistics and updates the
    running statistics as flax `nn.BatchNorm` does: running = 0.9 * running
    + 0.1 * batch (torch momentum 0.1), with the *biased* batch variance.
    torch's batch norm updates the running statistics in its own pass over
    the batch but puts the unbiased variance, n/(n-1) times larger, into
    `running_var`; the batch's share of it is scaled back on the [C] vector.
    """

    def _check_input_dim(self, input):
        if input.dim() < 3:
            raise ValueError(f"expected a [N, C, ...] map, got {tuple(input.shape)}")

    def folded(self):
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        mul = self.weight.float() * inv
        add = self.bias.float() - self.running_mean.float() * mul
        return mul, add

    def forward(self, x):
        if self.training:
            # Copies go into the op: autograd keeps its inputs, and the
            # buffers change again below and at the next call.
            mean, var = self.running_mean.clone(), self.running_var.clone()
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum,
                             self.eps)
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                kept = self.running_var * (1.0 - self.momentum)
                self.running_mean.copy_(mean)
                self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
                self.num_batches_tracked.add_(1)
            return y
        mul, add = self.folded()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * mul.to(x.dtype).view(shape) + add.to(x.dtype).view(shape)


class ConvNormAct(nn.Module):
    """2D conv (no bias) + BN + leaky-ReLU(0.1)."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = FoldedBatchNorm(cout)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class ConvBnReLU(nn.Module):
    """2D conv (no bias) + BN + ReLU; the visibility CNN's layer."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = FoldedBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv3dNormAct(nn.Module):
    """3D conv (no bias) + BN + ReLU."""

    def __init__(self, cin, cout, kernel=3, stride=1):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = FoldedBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _deconv3d(cin, cout, stride):
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    return nn.ConvTranspose3d(cin, cout, 3, s, padding=1,
                              output_padding=tuple(si - 1 for si in s), bias=False)


class Deconv3dNormAct(nn.Module):
    """Transposed 3D conv (k3, p1, output_padding s-1) + BN + ReLU: exact 2x
    on the strided axes. Reference keys `conv`/`bn`."""

    def __init__(self, cin, cout, stride=2):
        super().__init__()
        self.conv = _deconv3d(cin, cout, stride)
        self.bn = FoldedBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Deconv3dSeq(nn.Sequential):
    """The same block as a `Sequential` (reference keys `0`/`1`), as
    CostRegNet3D names it."""

    def __init__(self, cin, cout, stride=(1, 2, 2)):
        super().__init__(_deconv3d(cin, cout, stride), FoldedBatchNorm(cout), nn.ReLU())


class Deconv2dNormAct(nn.Sequential):
    """Transposed 2D conv (k4, s2, p1: exact 2x) + BN + activation."""

    def __init__(self, cin, cout, act: nn.Module):
        super().__init__(nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
                         FoldedBatchNorm(cout), act)


class ConvNormSeq(nn.Sequential):
    """Conv (with bias, 'same' padding) + BN + activation as a `Sequential`."""

    def __init__(self, cin, cout, kernel, act: nn.Module):
        super().__init__(nn.Conv2d(cin, cout, kernel, 1, (kernel - 1) // 2),
                         FoldedBatchNorm(cout), act)
