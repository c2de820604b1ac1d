"""Group-wise correlation and the depth entropy that feeds the visibility CNN.

Port of `mvsformer_tpu/ops/correlation.py` (cnn fusion only; the epipole
weights come with a later slice). Layouts follow the JAX functions:
volumes are [B, D, H, W, G]. All correlation maths is fp32.
"""

from __future__ import annotations

import torch


def groupwise_correlation(ref_fea, warped, groups: int):
    """G-group mean inner product: ref [B,H,W,C], warped [B,D,H,W,C] ->
    [B, D, H, W, G] fp32."""
    B, D, H, W, C = warped.shape
    ref = ref_fea.float().reshape(B, 1, H, W, groups, C // groups)
    src = warped.float().reshape(B, D, H, W, groups, C // groups)
    return (ref * src).mean(dim=-1)


def entropy_over_depth(corr):
    """Entropy over D of softmax(sum_g corr): [B,D,H,W,G] -> [B,H,W,1]."""
    sim = corr.detach().sum(dim=-1)
    p = torch.softmax(sim, dim=1)
    ent = -(p * torch.log(p + 1e-7)).sum(dim=1)
    return ent[..., None]
