"""TF32 splitting and mma B-fragment packing for the 3xTF32 kernels.

K2 (`csrc/vis_net.cu`), K4 (`csrc/encoder_head.cu`) and K5
(`csrc/fpn_level.cu`) run their convs on the tensor cores in 3xTF32: each operand is split into hi = tf32(x) and
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


def split_tf32_trunc(x):
    """(hi, lo) with hi = x truncated to TF32 and lo = x - hi truncated, as
    `csrc/encoder_head.cu` splits an activation where it reads it (two logic
    ops and a subtraction): hi + lo is x within 2^-20 |x|."""
    hi = (x.view(torch.int32) & -0x2000).view(torch.float32)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def pack_b(kmat):
    """kmat [..., K, N] (K and N multiples of 8), the B operand of a GEMM
    -> its TF32 hi and lo parts in mma.m16n8k8 B-fragment order, [..., K/8
    chunks, N/8, 32 lanes, 4].

    Fragment (chunk, f) is the 8x8 block of rows 8 chunk .. 8 chunk + 7 and
    columns 8f .. 8f + 7. Lane 4g + t holds b0 (row t) and b1 (row t + 4)
    of column g as (hi b0, hi b1, lo b0, lo b1), where rows t and t + 4 are
    GEMM rows 8 chunk + 2t and 8 chunk + 2t + 1 (the kernels order the A
    columns the same way)."""
    *lead, K, N = kmat.shape
    if K % 8 or N % 8:
        raise ValueError(f"pack_b: K and N must be multiples of 8, got {(K, N)}")
    nl = len(lead)
    # [..., chunk, t, row pair, f, g] -> [..., chunk, f, g, t, row pair]
    perm = (*range(nl), nl, nl + 3, nl + 4, nl + 1, nl + 2)
    parts = [part.reshape(*lead, K // 8, 4, 2, N // 8, 8).permute(perm)
             for part in split_tf32(kmat.float().contiguous())]
    return torch.stack(parts, dim=-2).reshape(*lead, K // 8, N // 8, 32, 4).contiguous()


def pack_conv(k):
    """k [co, ci, kh, kw], ci and co multiples of 8 -> its TF32 hi and lo
    parts in B-fragment order, [ci/8 chunks, kh*kw taps, co/8, 32 lanes, 4]:
    the GEMM rows of tap (ky, kx) = ky kw + kx, chunk c are input channels
    8c .. 8c + 7 (`pack_b`)."""
    co, ci, kh, kw = k.shape
    if co % 8 or ci % 8:
        raise ValueError(f"pack_conv: k must be [8m, 8n, kh, kw], got {tuple(k.shape)}")
    kmat = k.permute(2, 3, 1, 0).reshape(kh * kw, ci, co)  # [tap, ci, co]
    return pack_b(kmat).transpose(0, 1).contiguous()


def pack_conv3x3(k):
    """k [co, ci, 3, 3], ci and co multiples of 8 -> `pack_conv(k)`,
    [ci/8 chunks, 9 taps, co/8, 32 lanes, 4]."""
    if tuple(k.shape[2:]) != (3, 3) or k.shape[0] % 8 or k.shape[1] % 8:
        raise ValueError(f"pack_conv3x3: k must be [8m, 8n, 3, 3], got {tuple(k.shape)}")
    return pack_conv(k)


def pack_conv_rows(k):
    """k [co, ci, kh, kw], co a multiple of 8 and ci small -> its TF32 hi
    and lo parts in B-fragment order, [kh, K/8 chunks, co/8, 32 lanes, 4]:
    per kernel row ky, the GEMM rows are j = kx ci + c (tap kx, channel c:
    the values of one image row that a pixel-major image holds contiguous),
    padded with zero weights to K, the next multiple of 8 (24 for K4's
    7x7 conv of 3 channels)."""
    co, ci, kh, kw = k.shape
    if co % 8:
        raise ValueError(f"pack_conv_rows: co must be a multiple of 8, got {tuple(k.shape)}")
    kmat = k.permute(2, 3, 1, 0).reshape(kh, kw * ci, co)  # [ky, (kx, c), co]
    pad = -(kw * ci) % 8
    kmat = torch.cat([kmat, kmat.new_zeros(kh, pad, co)], dim=1)
    return pack_b(kmat)
