"""Depth decoding from probability volumes ([B, D, H, W], depth axis 1).

Port of `mvsformer_tpu/ops/regression.py` for the eval `ce`/`was` decode.
`decode_depth` here is the plain version of the depth-decode kernel in
`ops/stage_tail.py`.
"""

from __future__ import annotations

import torch


def depth_regression(prob, depth_values):
    """Soft-argmax expected depth; depths [B, D] or [B, D, H, W]."""
    if depth_values.dim() == 2:
        depth_values = depth_values[:, :, None, None]
    return (prob * depth_values).sum(dim=1)


def temperature_regression(logits, depth_values, tmp: float):
    """Eval temperature-sharpened soft-argmax."""
    return depth_regression(torch.softmax(logits * tmp, dim=1), depth_values)


def decode_depth(logits, depth_values, depth_type: str, tmp: float):
    """Eval decode -> (depth [B,H,W], photometric confidence [B,H,W]).

    For `ce`/`was`: depth = sum_d softmax(tmp * logits)_d * dv_d and
    confidence = max_d softmax(logits)_d. The training decodes and the
    other depth types come with later slices.
    """
    if depth_type not in ("ce", "was"):
        raise NotImplementedError(f"eval decode for depth_type={depth_type!r}")
    depth = temperature_regression(logits, depth_values, tmp)
    conf = torch.softmax(logits, dim=1).amax(dim=1)
    return depth, conf.detach()
