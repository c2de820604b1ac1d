"""The depth axis of the process grid: the cost regularisers over slabs of
the cost volume's depth hypotheses (eval).

The JAX package constrains `volume_mean`'s D axis to its "depth" mesh axis
(`mvsformer_tpu/models/stagenet.py:334-336`) and lets GSPMD insert the
halo exchange that the 3D U-Nets' convolutions need across the slabs'
edges. Here that exchange is written out. Every rank of a depth group
holds the whole volume (each computes the warp and the view sum, as the
JAX package leaves them unconstrained), takes its slab of the D axis,
runs the regulariser `models/costreg.py` picks over it, and gathers the
logits, so that the decode runs over the full D on every rank and each
rank returns the serial outputs.

A level of a U-Net (one depth extent n) is split when n divides by the
depth size: rank z holds planes [z n / size, (z + 1) n / size). A level
that does not divide is gathered: every rank holds all of it. A stride-2
level of a split level is split again only if it divides, so once a level
is gathered the deeper ones are too (`CostRegNet` at D = 8 over 2 ranks
splits 8, 4 and 2 and gathers its bottleneck of 1; at D = 16 over 4
ranks, its bottleneck of 2).

A 3D conv or transposed conv (`nn.Conv3d`, `nn.ConvTranspose3d`) over a
level computes this rank's output planes from the input planes they read,
with no padding in D: the planes beyond the level's ends are zeros (the
serial op's padding), and the planes beyond the slab's edges come from the
neighbouring ranks. One `all_gather` over the depth group moves every
rank's edge planes (the first and last few of its slab), the collective
that gloo takes for CUDA tensors as NCCL does; a split input whose output
is gathered is gathered whole first. The kernel's D extent and stride set
the halo: 3x3x3 convs at stride 1 read one plane on each side, stride-2
convs one on the left, stride-2 transposed convs one on the right; (1, 3,
3) kernels none. Eval BN (folded) and the ReLUs act per plane; GroupNorm
and instance norm normalise over D too, so over a split level their sums
are all-reduced over the depth group (two passes: the mean, then the sum
of squares about it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from mvsformer_torch.models.blocks import Conv3dNormAct, Deconv3dNormAct, f32, like


class Slab:
    """A U-Net level's tensor [B, C, d, H, W] on this rank: its planes of a
    level `size` planes deep (all of them where the level is gathered)."""

    __slots__ = ("t", "size")

    def __init__(self, t, size: int):
        self.t, self.size = t, size

    def __add__(self, other: "Slab") -> "Slab":
        if other.size != self.size:
            raise ValueError(f"levels of {self.size} and {other.size} planes do not add")
        return Slab(self.t + other.t, self.size)


def _layers(block):
    """A regulariser block as the layers its forward runs, in order."""
    if isinstance(block, (Conv3dNormAct, Deconv3dNormAct)):
        return block.layers()
    if isinstance(block, nn.Sequential):
        return tuple(block)
    return (block,)


class DepthSlabs:
    """This rank's part of a depth group of `size` ranks, at `index`."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def bounds(self, n: int) -> tuple:
        """This rank's planes [start, stop) of a level n planes deep."""
        if n % self.size:
            return 0, n
        chunk = n // self.size
        return self.index * chunk, (self.index + 1) * chunk

    def split(self, x) -> Slab:
        """This rank's slab of a whole volume [B, C, D, H, W]."""
        start, stop = self.bounds(x.shape[2])
        return Slab(x[:, :, start:stop], x.shape[2])

    def gather(self, a: Slab):
        """The whole level of `a` on every rank."""
        if a.size % self.size:
            return a.t
        parts = [torch.empty_like(a.t) for _ in range(self.size)]
        dist.all_gather(parts, a.t.contiguous(), group=self.group)
        return torch.cat(parts, dim=2)

    def _planes(self, a: Slab, lo: int, hi: int, split_out: bool):
        """Planes [lo, hi) of `a`'s level, zeros outside [0, a.size): from
        this rank's slab and its neighbours' edges where the output is
        split, from the whole level where it is gathered."""
        start, stop = self.bounds(a.size)
        if a.size % self.size == 0 and split_out:
            left, right = start - lo, hi - stop
            chunk = stop - start
            if not (0 <= left <= chunk and 0 <= right <= chunk):
                raise ValueError(f"a halo of {left} and {right} planes over slabs of {chunk}")
            x = a.t
            if left or right:
                edge = torch.cat([x[:, :, :right], x[:, :, chunk - left:]], dim=2).contiguous()
                parts = [torch.empty_like(edge) for _ in range(self.size)]
                dist.all_gather(parts, edge, group=self.group)
                zeros = x.new_zeros(x.shape[:2] + (left,) + x.shape[3:])
                below = parts[self.index - 1][:, :, right:] if self.index > 0 else zeros
                zeros = x.new_zeros(x.shape[:2] + (right,) + x.shape[3:])
                above = parts[self.index + 1][:, :, :right] \
                    if self.index < self.size - 1 else zeros
                x = torch.cat([below, x, above], dim=2)
            return x
        x = self.gather(a)
        pad = (0, 0, 0, 0, max(0, -lo), max(0, hi - a.size))
        return F.pad(x[:, :, max(0, lo):min(hi, a.size)], pad)

    def conv(self, layer, a: Slab) -> Slab:
        """A `Conv3d` or `ConvTranspose3d` over a level: this rank's output
        planes."""
        kd, sd, pd = layer.kernel_size[0], layer.stride[0], layer.padding[0]
        transposed = isinstance(layer, nn.ConvTranspose3d)
        if layer.dilation[0] != 1:
            raise ValueError("a dilated depth kernel")
        if transposed:
            n = (a.size - 1) * sd - 2 * pd + kd + layer.output_padding[0]
        else:
            n = (a.size + 2 * pd - kd) // sd + 1
        o0, o1 = self.bounds(n)
        split_out = n % self.size == 0
        if transposed:  # inputs i with o0 <= i * sd - pd + k < o1 for some k < kd
            lo, hi = -(-(o0 + pd - kd + 1) // sd), (o1 - 1 + pd) // sd + 1
        else:  # output o reads o * sd - pd + k, k < kd
            lo, hi = o0 * sd - pd, (o1 - 1) * sd - pd + kd
        x = self._planes(a, lo, hi, split_out)
        w, b = like(layer.weight, x), like(layer.bias, x)
        if transposed:
            y = F.conv_transpose3d(x, w, b, (sd,) + layer.stride[1:], (0,) + layer.padding[1:],
                                   (0,) + layer.output_padding[1:], layer.groups)
            first = o0 - (lo * sd - pd)
            y = y[:, :, first:first + o1 - o0]
        else:
            y = F.conv3d(x, w, b, layer.stride, (0,) + layer.padding[1:], 1, layer.groups)
        return Slab(y, n)

    def group_norm(self, layer: nn.GroupNorm, a: Slab) -> Slab:
        """GroupNorm (and instance norm) over a level: over a split level
        its per-group sums are all-reduced over the depth group."""
        if a.size % self.size:
            return Slab(layer(a.t), a.size)
        x = f32(a.t)
        B, C = x.shape[:2]
        xg = x.reshape(B, layer.num_groups, -1)
        count = xg.shape[2] * self.size
        total = xg.sum(2)
        dist.all_reduce(total, group=self.group)
        centred = xg - (total / count)[..., None]
        sq = centred.square().sum(2)
        dist.all_reduce(sq, group=self.group)
        y = (centred * torch.rsqrt(sq / count + layer.eps)[..., None]).reshape(x.shape)
        shape = (1, C) + (1,) * (x.dim() - 2)
        y = y * layer.weight.view(shape) + layer.bias.view(shape)
        return Slab(y.to(a.t.dtype), a.size)

    def run(self, block, a: Slab) -> Slab:
        """One block of a regulariser (`models/costreg.py`) over a level."""
        for layer in _layers(block):
            if isinstance(layer, (nn.Conv3d, nn.ConvTranspose3d)):
                a = self.conv(layer, a)
            elif isinstance(layer, nn.GroupNorm):
                a = self.group_norm(layer, a)
            else:  # eval BN (folded), ReLU, Identity: per plane
                a = Slab(layer(a.t), a.size)
        return a

    def regularise(self, cost_reg, volume):
        """`cost_reg(volume)` [B, 1, D, H, W] on every rank, each rank
        regularising its slab of `volume`'s D axis."""
        return self.gather(cost_reg(self.split(volume), run=self.run))
