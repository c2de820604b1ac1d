"""Group-wise correlation and the depth entropy that feeds the visibility CNN.

Port of `mvsformer_tpu/ops/correlation.py` (cnn fusion only; the epipole
weights come with a later slice). Layouts follow the JAX functions:
volumes are [B, D, H, W, G]. All correlation maths is fp32 (fp64 stays
fp64, for gradient checks).
"""

from __future__ import annotations

import torch


def groupwise_correlation(ref_fea, warped, groups: int):
    """G-group mean inner product: ref [B,H,W,C], warped [B,D,H,W,C] ->
    [B, D, H, W, G] fp32."""
    B, D, H, W, C = warped.shape
    dtype = torch.promote_types(warped.dtype, torch.float32)
    ref = ref_fea.to(dtype).reshape(B, 1, H, W, groups, C // groups)
    src = warped.to(dtype).reshape(B, D, H, W, groups, C // groups)
    return (ref * src).mean(dim=-1)


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
