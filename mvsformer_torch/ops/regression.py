"""Depth decoding from probability volumes ([B, D, H, W], depth axis 1).

Port of `mvsformer_tpu/ops/regression.py`: the `depth_type` dispatch of
`decode_depth` (`ce`/`was`: the eval temperature regression, of which
this is the plain version of the depth-decode kernel in
`ops/stage_tail.py`, and the training argmax; `mixup_ce`: the two-bin
decode; `re`: the soft-argmax with a windowed confidence).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def depth_regression(prob, depth_values):
    """Soft-argmax expected depth; depths [B, D] or [B, D, H, W]."""
    if depth_values.dim() == 2:
        depth_values = depth_values[:, :, None, None]
    return (prob * depth_values).sum(dim=1)


def select_bin(vol, idx):
    """Per-pixel bin selection as a one-hot multiply-reduce over D, as the
    JAX function computes it (no gather; its backward is a multiply).

    vol [B, D, H, W] (or a [B, D] table), idx [B, H, W] integer in [0, D)
    -> [B, H, W]."""
    ndepth = vol.shape[1]
    if vol.dim() == 2:
        vol = vol[:, :, None, None]
    iota = torch.arange(ndepth, device=vol.device).view(1, ndepth, 1, 1)
    onehot = (iota == idx[:, None]).to(vol.dtype)
    return (vol * onehot).sum(dim=1)


def conf_regression(prob, n: int = 4):
    """The probability summed over an n-bin window around the regressed bin
    index (the window starts n // 2 - 1 bins below it for even n, n // 2
    for odd n), without gradient."""
    prob = prob.detach()
    B, D = prob.shape[:2]
    pad_lo, pad_hi = (n // 2, n // 2) if n % 2 else (n // 2 - 1, n // 2)
    padded = F.pad(prob, (0, 0, 0, 0, pad_lo, pad_hi))
    csum = torch.cat([torch.zeros_like(padded[:, :1]), torch.cumsum(padded, dim=1)], dim=1)
    win = csum[:, n:] - csum[:, :-n]
    bins = torch.arange(D, dtype=prob.dtype, device=prob.device)[None].expand(B, D)
    idx = depth_regression(prob, bins).to(torch.int32).clamp(0, D - 1)
    return select_bin(win, idx)


def argmax_depth(prob, depth_values):
    """The depth of the most probable bin (the first, on a tie)."""
    return select_bin(depth_values, prob.argmax(dim=1))


def temperature_regression(logits, depth_values, tmp: float):
    """Eval temperature-sharpened soft-argmax."""
    return depth_regression(torch.softmax(logits * tmp, dim=1), depth_values)


def mixup_depth(prob, depth_values):
    """Two-bin decode: the most probable pair of neighbouring bins, its
    depths mixed by their probabilities. -> (depth, confidence = the pair's
    probability) [B, H, W]."""
    prob_l, prob_r = prob[:, :-1], prob[:, 1:]
    mix = prob_l + prob_r
    conf = mix.amax(dim=1)
    idx = mix.argmax(dim=1)
    denom = prob_l + prob_r + 1e-7
    if depth_values.dim() == 2:
        depth_values = depth_values[:, :, None, None]
    mix_depth = depth_values[:, :-1] * (prob_l / denom) + depth_values[:, 1:] * (prob_r / denom)
    return select_bin(mix_depth, idx), conf


# The `re` confidence's window by the stage's depth count; any other count
# takes the maximum probability.
CONF_WINDOW = {8: 2, 16: 3}


def decode_depth(logits, depth_values, depth_type: str, tmp: float, training: bool = False):
    """-> (depth [B,H,W], photometric confidence [B,H,W] without gradient).

    `ce`/`was`: in eval, depth = sum_d softmax(tmp * logits)_d * dv_d; in
    training, the depth of the argmax bin (no gradient); confidence
    max_d softmax(logits)_d. `mixup_ce`: `mixup_depth`. `re`: the
    soft-argmax of softmax(logits), confidence `conf_regression` with a
    window of 4 bins for D >= 32, 3 for D = 16, 2 for D = 8, else the
    maximum probability.
    """
    prob = torch.softmax(logits, dim=1)
    ndepth = logits.shape[1]
    if depth_type in ("ce", "was"):
        if training:
            depth = argmax_depth(prob, depth_values).detach()
        else:
            depth = temperature_regression(logits, depth_values, tmp)
        conf = prob.amax(dim=1)
    elif depth_type == "mixup_ce":
        depth, conf = mixup_depth(prob, depth_values)
    elif depth_type == "re":
        depth = depth_regression(prob, depth_values)
        n = 4 if ndepth >= 32 else CONF_WINDOW.get(ndepth)
        conf = conf_regression(prob, n) if n else prob.amax(dim=1)
    else:
        raise ValueError(f"unknown depth_type {depth_type!r}")
    return depth, conf.detach()
