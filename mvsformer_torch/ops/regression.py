"""Depth decoding from probability volumes ([B, D, H, W], depth axis 1).

Port of `mvsformer_tpu/ops/regression.py` for the `ce`/`was` decodes: the
eval temperature regression (`decode_depth` is the plain version of the
depth-decode kernel in `ops/stage_tail.py`) and the training argmax decode.
"""

from __future__ import annotations

import torch


def depth_regression(prob, depth_values):
    """Soft-argmax expected depth; depths [B, D] or [B, D, H, W]."""
    if depth_values.dim() == 2:
        depth_values = depth_values[:, :, None, None]
    return (prob * depth_values).sum(dim=1)


def select_bin(vol, idx):
    """Per-pixel bin selection as a one-hot multiply-reduce over D, as the
    JAX function computes it (no gather; its backward is a multiply).

    vol [B, D, H, W], idx [B, H, W] integer in [0, D) -> [B, H, W]."""
    ndepth = vol.shape[1]
    iota = torch.arange(ndepth, device=vol.device).view(1, ndepth, 1, 1)
    onehot = (iota == idx[:, None]).to(vol.dtype)
    return (vol * onehot).sum(dim=1)


def argmax_depth(prob, depth_values):
    """The depth of the most probable bin (the first, on a tie)."""
    return select_bin(depth_values, prob.argmax(dim=1))


def temperature_regression(logits, depth_values, tmp: float):
    """Eval temperature-sharpened soft-argmax."""
    return depth_regression(torch.softmax(logits * tmp, dim=1), depth_values)


def decode_depth(logits, depth_values, depth_type: str, tmp: float, training: bool = False):
    """-> (depth [B,H,W], photometric confidence [B,H,W]).

    For `ce`/`was`: in eval, depth = sum_d softmax(tmp * logits)_d * dv_d;
    in training, the depth of the argmax bin (no gradient). The confidence
    is max_d softmax(logits)_d, without gradient. The other depth types
    come with later slices.
    """
    if depth_type not in ("ce", "was"):
        raise NotImplementedError(f"decode for depth_type={depth_type!r}")
    prob = torch.softmax(logits, dim=1)
    if training:
        depth = argmax_depth(prob, depth_values).detach()
    else:
        depth = temperature_regression(logits, depth_values, tmp)
    return depth, prob.amax(dim=1).detach()
