"""Conv / norm / activation building blocks (NCHW and NCDHW).

Port of `mvsformer_tpu/models/blocks.py`. Convolutions use torch-convention
padding p = (k - 1) // 2; transposed convolutions use the reference's
padding and output_padding, so the outputs are exact 2x upsamples. Every
block takes the model's `norm_type` (`make_norm`). Module attribute names
are the reference checkpoint's (`conv`/`bn`, or the `Sequential` indices)
whatever the norm, which is what the weight bridge maps.

The compute dtype follows the activations, as flax's `dtype` sets it for
the JAX modules: the layers here (`Conv2d`, `Conv3d`, `ConvTranspose2d`,
`ConvTranspose3d`, `Linear`) cast their weights to their input's dtype
where they use them, so a bf16 activation runs a bf16 convolution or
matmul with fp32 accumulation, while parameters, their gradients, the
optimizer's state and checkpoints stay fp32. The norms are fp32 islands:
`LayerNorm`, `GroupNorm` and the training `FoldedBatchNorm` normalise in
fp32 and return their input's dtype, and the eval `FoldedBatchNorm` folds
in fp32 and applies the affine in the input's dtype, as the JAX package's
eval BN does. With fp32 (or float64) activations every cast is the
identity, so those paths are unchanged.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def like(t, x):
    """The parameter `t` (or None) in the dtype of the activation `x`."""
    return None if t is None else t.to(x.dtype)


def f32(x):
    """`x` in at least fp32: bf16 goes up, fp32 and float64 stay."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, like(self.weight, x), like(self.bias, x))


class Conv3d(nn.Conv3d):
    def forward(self, x):
        return self._conv_forward(x, like(self.weight, x), like(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, like(self.weight, x), like(self.bias, x), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class ConvTranspose3d(nn.ConvTranspose3d):
    def forward(self, x):
        return F.conv_transpose3d(x, like(self.weight, x), like(self.bias, x), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, like(self.weight, x), like(self.bias, x))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(f32(x), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(f32(x), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


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

    With a `data_group` (set by the model's layout, `parallel/mesh.py`)
    training synchronises the statistics over the data ranks, as flax's
    `BatchNorm(axis_name="data")` does: each rank's mean goes through a
    differentiable all-reduce-mean, then each rank's mean square about that
    global mean through another, which is the global biased variance; the
    output is normalised by these global statistics and the running
    statistics take them. (flax all-reduces E[x] and E[x^2] at once; their
    difference cancels in fp32 where a channel's mean is large beside its
    spread, and the serial batch norm's variance is two-pass, as this one
    is. `torch.nn.SyncBatchNorm` would put the unbiased variance in the
    running statistics, E3.)
    """

    data_group = None

    def _check_input_dim(self, input):
        if input.dim() < 3:
            raise ValueError(f"expected a [N, C, ...] map, got {tuple(input.shape)}")

    def _synced(self, x):
        from mvsformer_torch.parallel.mesh import all_mean

        x32 = f32(x)
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = all_mean(x32.mean(dims), self.data_group)
        centred = x32 - mean.view(shape)
        var = all_mean(centred.square().mean(dims), self.data_group)
        mul = self.weight * torch.rsqrt(var + self.eps)
        y = centred * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    def folded(self):
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        mul = self.weight.float() * inv
        add = self.bias.float() - self.running_mean.float() * mul
        return mul, add

    def forward(self, x):
        if self.training and self.data_group is not None:
            return self._synced(x)
        if self.training:
            # Copies go into the op: autograd keeps its inputs, and the
            # buffers change again below and at the next call.
            mean, var = self.running_mean.clone(), self.running_var.clone()
            y = F.batch_norm(f32(x), mean, var, self.weight, self.bias, True, self.momentum,
                             self.eps).to(x.dtype)
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


def group_count(kind: str, channels: int) -> int:
    """GroupNorm's groups: `IN` one per channel; `GN` min(8, C), lowered
    until it divides C."""
    if kind == "IN":
        return channels
    groups = min(8, channels)
    while channels % groups:
        groups -= 1
    return groups


NORMS = ("BN", "GN", "IN", "none")


def make_norm(kind: str, channels: int) -> nn.Module:
    """The normalisation after a conv, as the JAX package's `Norm` picks it:
    `BN` batch norm (folded in eval), `GN` group norm, `IN` instance norm
    (group norm with one group per channel; affine and without running
    statistics, as flax's), `none` nothing. The group norms take flax's
    eps of 1e-6."""
    if kind == "BN":
        return FoldedBatchNorm(channels)
    if kind in ("GN", "IN"):
        return GroupNorm(group_count(kind, channels), channels, eps=1e-6)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm_type {kind!r}; one of {NORMS}")


def _pad(kernel):
    return tuple((k - 1) // 2 for k in kernel) if isinstance(kernel, tuple) else (kernel - 1) // 2


class ConvNormAct(nn.Module):
    """2D conv + norm + leaky-ReLU(0.1); the conv has a bias only without a
    norm."""

    def __init__(self, cin, cout, kernel=3, stride=1, norm="BN"):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=norm == "none")
        self.bn = make_norm(norm, cout)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.conv(x)), 0.1)


class ConvBnReLU(nn.Module):
    """2D conv (no bias) + norm + ReLU; the visibility CNN's layer."""

    def __init__(self, cin, cout, kernel=3, stride=1, norm="BN"):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.bn = make_norm(norm, cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Conv3dNormAct(nn.Module):
    """3D conv + norm + ReLU; the conv has a bias only without a norm.
    `kernel` an int or a (kd, kh, kw) tuple, padded (k - 1) // 2 per axis."""

    def __init__(self, cin, cout, kernel=3, stride=1, norm="BN"):
        super().__init__()
        self.conv = Conv3d(cin, cout, kernel, stride, _pad(kernel), bias=norm == "none")
        self.bn = make_norm(norm, cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _deconv3d(cin, cout, stride):
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    return ConvTranspose3d(cin, cout, 3, s, padding=1,
                           output_padding=tuple(si - 1 for si in s), bias=False)


class Deconv3dNormAct(nn.Module):
    """Transposed 3D conv (k3, p1, output_padding s-1) + norm + ReLU: exact
    2x on the strided axes. Reference keys `conv`/`bn`."""

    def __init__(self, cin, cout, stride=2, norm="BN"):
        super().__init__()
        self.conv = _deconv3d(cin, cout, stride)
        self.bn = make_norm(norm, cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Deconv3dSeq(nn.Sequential):
    """The same block as a `Sequential` (reference keys `0`/`1`), as
    CostRegNet3D names it."""

    def __init__(self, cin, cout, stride=(1, 2, 2), norm="BN"):
        super().__init__(_deconv3d(cin, cout, stride), make_norm(norm, cout), nn.ReLU())


class Deconv2dIn3dSeq(nn.Sequential):
    """Transposed 3D conv with a (1, 3, 3) kernel, stride (1, 2, 2), padding
    (0, 1, 1) and output padding (0, 1, 1) (an exact 2x in H and W, each
    depth plane on its own) + norm + ReLU, as CostRegNet2D names it (keys
    `0`/`1`)."""

    def __init__(self, cin, cout, norm="BN"):
        super().__init__(ConvTranspose3d(cin, cout, (1, 3, 3), (1, 2, 2), padding=(0, 1, 1),
                                         output_padding=(0, 1, 1), bias=False),
                         make_norm(norm, cout), nn.ReLU())


class Deconv2dNormAct(nn.Sequential):
    """Transposed 2D conv (k4, s2, p1: exact 2x) + norm + activation."""

    def __init__(self, cin, cout, act: nn.Module, norm="BN"):
        super().__init__(ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
                         make_norm(norm, cout), act)


class ConvNormSeq(nn.Sequential):
    """Conv (with bias, 'same' padding) + norm + activation as a
    `Sequential`."""

    def __init__(self, cin, cout, kernel, act: nn.Module, norm="BN"):
        super().__init__(Conv2d(cin, cout, kernel, 1, (kernel - 1) // 2),
                         make_norm(norm, cout), act)
