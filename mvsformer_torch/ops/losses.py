"""Training losses for the cascade's depth probability volumes.

Port of `mvsformer_tpu/ops/losses.py` for `depth_type="ce"`: per-stage
cross-entropy to the nearest depth bin, with the inverse-depth flip and
out-of-range masking, and its focal variant. As in the JAX package, every
loss is a mask-weighted mean in fp32 with no boolean indexing, so its
shapes never depend on the data. The `re`, `was` and `mixup_ce` losses come
with a later slice.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops.regression import select_bin

STAGE_KEYS = ("stage1", "stage2", "stage3", "stage4")


def _masked_mean(x, mask, eps: float = 1e-6):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / (mask.sum() + eps)


def _range_and_bins(depth_values, depth_gt, inverse_depth: bool):
    """depth_values [B, D, H, W], depth_gt [B, H, W] -> (gt_index [B,H,W]
    int64, in_range [B,H,W] fp32, the (flipped) depth values)."""
    if inverse_depth:
        depth_values = torch.flip(depth_values, dims=(1,))
    gt = depth_gt[:, None]
    intervals = (depth_values[:, 1:] - depth_values[:, :-1]).abs() / 2.0
    intervals = torch.cat([intervals, intervals[:, -1:]], dim=1)
    min_dv = depth_values[:, 0:1] - intervals[:, 0:1]
    max_dv = depth_values[:, -1:] + intervals[:, -1:]
    right_edges = depth_values + intervals
    out_left = (gt < min_dv).float()
    out_right = (gt > max_dv).float()
    in_range = (1.0 - (out_left + out_right).clamp(0.0, 1.0))[:, 0]
    gt_index = (right_edges <= gt).float().sum(dim=1)
    gt_index = gt_index.clamp(0, depth_values.shape[1] - 1).long()
    return gt_index, in_range, depth_values


def masked_cross_entropy(logits, labels, mask):
    """CE over depth axis 1 of [B, D, H, W] logits, mask-weighted mean."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return _masked_mean(-select_bin(logp, labels), mask)


def focal_ce(logits, labels, mask, gamma: float):
    """Focal cross-entropy, mask-weighted mean over pixels."""
    logp_t = select_bin(torch.log_softmax(logits.float(), dim=1), labels)
    return _masked_mean(-((1.0 - torch.exp(logp_t)) ** gamma) * logp_t, mask)


def ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw=(1.0, 1.0, 1.0, 1.0),
                   focal: bool = False, gamma: float = 0.0, inverse_depth: bool = True,
                   stage_keys=STAGE_KEYS) -> dict:
    """Per-stage nearest-bin cross-entropy: {stage key: weighted loss}."""
    loss_dict = {}
    for i, key in enumerate(stage_keys):
        stage = outputs[key]
        logits = stage["prob_volume_pre"].float()
        if inverse_depth:
            logits = torch.flip(logits, dims=(1,))
        gt_index, in_range, _ = _range_and_bins(stage["depth_values"].float(),
                                                depth_gt_ms[key].float(), inverse_depth)
        final_mask = in_range * (mask_ms[key] > 0.5).float()
        if focal:
            loss = focal_ce(logits, gt_index, final_mask, gamma)
        else:
            loss = masked_cross_entropy(logits, gt_index, final_mask)
        loss_dict[key] = dlossw[i] * loss
    return loss_dict


def total_loss(outputs, depth_gt_ms, mask_ms, depth_interval, depth_type: str = "ce",
               dlossw=(1.0, 1.0, 1.0, 1.0), focal: bool = False, gamma: float = 0.0,
               inverse_depth: bool = True, stage_keys=STAGE_KEYS):
    """-> (sum of the stage losses, {stage key: loss}). `depth_interval`
    [B] is read by the `re` loss, which comes with a later slice."""
    if depth_type != "ce":
        raise NotImplementedError(f"the {depth_type!r} loss is not ported yet")
    del depth_interval
    loss_dict = ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw, focal=focal,
                               gamma=gamma, inverse_depth=inverse_depth,
                               stage_keys=stage_keys)
    return sum(loss_dict.values()), loss_dict
