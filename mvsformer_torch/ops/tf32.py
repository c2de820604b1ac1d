"""TF32 splitting and mma B-fragment packing for the 3xTF32 kernels.

K2 (`csrc/vis_net.cu`) and K5 (`csrc/fpn_level.cu`) run their 3x3 convs on
the tensor cores in 3xTF32: each operand is split into hi = tf32(x) and
lo = tf32(x - hi), and each product summed as lo*hi + hi*lo + hi*hi in
fp32, which keeps fp32's accuracy where one TF32 product keeps about three
decimal digits. These are the plain helpers their wrappers split and pack
the weights with, on the weights' device; `csrc/tf32_mma.cuh` holds the
device side.
"""

from __future__ import annotations

import torch


def tf32_round(x):
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32` rounds: the 13 low mantissa bits are 0."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): hi + lo is x within
    2^-22 |x| (x - hi is exact in float32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pack_conv3x3(k):
    """k [co, ci, 3, 3], ci and co multiples of 8 -> its TF32 hi and lo parts
    in mma.m16n8k8 B-fragment order, [ci/8 chunks, 9 taps, co/8, 32 lanes, 4].

    Fragment (chunk, tap = 3 ky + kx, f) is the 8x8 block of input channels
    8 chunk .. 8 chunk + 7 and output channels 8f .. 8f + 7. Lane 4g + t
    holds b0 (row t) and b1 (row t + 4) of column g as (hi b0, hi b1, lo b0,
    lo b1), where rows t and t + 4 are input channels 8 chunk + 2t and
    8 chunk + 2t + 1 (the kernels order the A columns the same way)."""
    co, ci = k.shape[:2]
    if co % 8 or ci % 8 or tuple(k.shape[2:]) != (3, 3):
        raise ValueError(f"pack_conv3x3: k must be [8m, 8n, 3, 3], got {tuple(k.shape)}")
    parts = [part.reshape(co // 8, 8, ci // 8, 4, 2, 9).permute(2, 5, 0, 1, 3, 4)
             for part in split_tf32(k.float().contiguous())]  # [chunk, tap, f, g, t, row pair]
    return torch.stack(parts, dim=-2).reshape(ci // 8, 9, co // 8, 32, 4).contiguous()
