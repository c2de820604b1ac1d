"""Group-wise correlation and the depth entropy that feeds the visibility CNN.

Port of `mvsformer_tpu/ops/correlation.py`: the correlation, the entropy
that feeds the cnn fusion's visibility CNN, the epipole fusions'
per-depth view weights, and the eval-time cosine-similarity diagnostic. Layouts follow the JAX functions: volumes are
[B, D, H, W, G] (any strided view). All correlation maths is fp32 (fp64
stays fp64, for gradient checks).
"""

from __future__ import annotations

import math

import torch


def groupwise_correlation(ref_fea, warped, groups: int):
    """G-group mean inner product: ref [B,H,W,C], warped [B,D,H,W,C] ->
    [B, D, H, W, G] fp32."""
    B, D, H, W, C = warped.shape
    dtype = torch.promote_types(warped.dtype, torch.float32)
    ref = ref_fea.to(dtype).reshape(B, 1, H, W, groups, C // groups)
    src = warped.to(dtype).reshape(B, D, H, W, groups, C // groups)
    return (ref * src).mean(dim=-1)


def cosine_similarity_volume(ref_fea, warped, groups: int):
    """The cosine-similarity diagnostic [B, D, H, W] of ref [B,H,W,C] and
    warped [B,D,H,W,C]: both grouped as (G, C/G), each normalised over the
    G axis (the reference's torch dim 1 of [B, G, C/G, ...]), then the
    product's mean over C/G and sum over G, in fp32."""
    B, D, H, W, C = warped.shape
    dtype = torch.promote_types(warped.dtype, torch.float32)
    ref = ref_fea.to(dtype).reshape(B, 1, H, W, groups, C // groups)
    src = warped.to(dtype).reshape(B, D, H, W, groups, C // groups)
    ref = ref / (torch.linalg.vector_norm(ref, dim=-2, keepdim=True) + 1e-12)
    src = src / (torch.linalg.vector_norm(src, dim=-2, keepdim=True) + 1e-12)
    return (ref * src).mean(dim=-1).sum(dim=-1)


def entropy_over_depth(corr):
    """Entropy over D of softmax(sum_g corr): [B,D,H,W,G] -> [B,H,W,1].

    The correlation is detached first, as the JAX function stops its
    gradient: the entropy feeds the visibility CNN and passes no gradient
    back to the correlation. Any strided view of the volume is taken, so the
    training forward applies it to K7's [B, V, G, D, H, W] output per view."""
    sim = corr.detach().sum(dim=-1)
    p = torch.softmax(sim, dim=1)
    ent = -(p * torch.log(p + 1e-7)).sum(dim=1)
    return ent[..., None]


def epipole_weight(corr, attn_temp: float, channels: int):
    """The epipole fusion's view weight [B, D, H, W]: softmax over depth of
    sum_g corr / attn_temp, over sqrt(channels)."""
    score = corr.sum(dim=-1) / attn_temp
    return torch.softmax(score, dim=1) / math.sqrt(channels)


def epipole_v2_weight(corr, attn_temp, invalid, groups: int):
    """epipoleV2's view weight [B, D, H, W]: the learned temperature
    `attn_temp` (a scalar tensor) clamped to [0.1, 10], a -1e4 bias on the
    bins whose projection leaves the source frustum (`invalid` [B, D, H,
    W] bool), softmax over depth, over sqrt(groups)."""
    score = corr.sum(dim=-1) / attn_temp.clamp(0.1, 10.0)
    score = score + (-10000.0) * invalid.to(score.dtype)
    return torch.softmax(score, dim=1) / math.sqrt(groups)
