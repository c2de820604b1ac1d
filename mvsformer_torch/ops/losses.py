"""Training losses for the cascade's depth probability volumes.

Port of `mvsformer_tpu/ops/losses.py`: per-stage cross-entropy to the
nearest depth bin, with the inverse-depth flip and out-of-range masking,
and its focal variant (`ce`); the two-bin mixup cross-entropy
(`mixup_ce`); smooth-L1 regression in units of the depth interval (`re`);
the Sinkhorn optimal-transport loss between the predicted and the ground
truth bin distributions (`was`); and the legacy single-map and bimodal
losses. As in the JAX package, every loss is a mask-weighted mean with no
boolean indexing, so its shapes never depend on the data; fp32 inputs are
computed in fp32 and float64 ones in float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.ops.hypotheses import hypothesis
from mvsformer_torch.ops.regression import select_bin

STAGE_KEYS = ("stage1", "stage2", "stage3", "stage4")


def _f(x):
    """At least fp32 (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _masked_mean(x, mask, eps: float = 1e-6):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / (mask.sum() + eps)


def smooth_l1(pred, target, beta: float = 1.0):
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _half_intervals(depth_values):
    """Half the gap to the next bin, the last bin's repeated: [B, D, H, W]."""
    intervals = (depth_values[:, 1:] - depth_values[:, :-1]).abs() / 2.0
    return torch.cat([intervals, intervals[:, -1:]], dim=1)


def _range_and_bins(depth_values, depth_gt, inverse_depth: bool):
    """depth_values [B, D, H, W], depth_gt [B, H, W] -> (gt_index [B,H,W]
    int64, in_range [B,H,W], the (flipped) depth values)."""
    if inverse_depth:
        depth_values = torch.flip(depth_values, dims=(1,))
    gt = depth_gt[:, None]
    intervals = _half_intervals(depth_values)
    min_dv = depth_values[:, 0:1] - intervals[:, 0:1]
    max_dv = depth_values[:, -1:] + intervals[:, -1:]
    right_edges = depth_values + intervals
    out_left = (gt < min_dv).to(depth_values.dtype)
    out_right = (gt > max_dv).to(depth_values.dtype)
    in_range = (1.0 - (out_left + out_right).clamp(0.0, 1.0))[:, 0]
    gt_index = (right_edges <= gt).to(depth_values.dtype).sum(dim=1)
    gt_index = gt_index.clamp(0, depth_values.shape[1] - 1).long()
    return gt_index, in_range, depth_values


def masked_cross_entropy(logits, labels, mask):
    """CE over depth axis 1 of [B, D, H, W] logits, mask-weighted mean."""
    logp = torch.log_softmax(_f(logits), dim=1)
    return _masked_mean(-select_bin(logp, labels), mask)


def focal_ce(logits, labels, mask, gamma: float):
    """Focal cross-entropy, mask-weighted mean over pixels."""
    logp_t = select_bin(torch.log_softmax(_f(logits), dim=1), labels)
    return _masked_mean(-((1.0 - torch.exp(logp_t)) ** gamma) * logp_t, mask)


def ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw=(1.0, 1.0, 1.0, 1.0),
                   focal: bool = False, gamma: float = 0.0, inverse_depth: bool = True,
                   stage_keys=STAGE_KEYS) -> dict:
    """Per-stage nearest-bin cross-entropy: {stage key: weighted loss}."""
    loss_dict = {}
    for i, key in enumerate(stage_keys):
        stage = outputs[key]
        logits = _f(stage["prob_volume_pre"])
        if inverse_depth:
            logits = torch.flip(logits, dims=(1,))
        gt_index, in_range, _ = _range_and_bins(_f(stage["depth_values"]),
                                                _f(depth_gt_ms[key]), inverse_depth)
        final_mask = in_range * (mask_ms[key] > 0.5).to(in_range.dtype)
        if focal:
            loss = focal_ce(logits, gt_index, final_mask, gamma)
        else:
            loss = masked_cross_entropy(logits, gt_index, final_mask)
        loss_dict[key] = dlossw[i] * loss
    return loss_dict


def mixup_ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw=(1.0, 1.0, 1.0, 1.0),
                         inverse_depth: bool = True, stage_keys=STAGE_KEYS) -> dict:
    """Two-bin mixup cross-entropy: the ground truth between bins k and k+1
    splits its weight between the CE of the left and the right softmax
    (over bins 0..D-2 and 1..D-1) at k, by its distance to each."""
    loss_dict = {}
    for i, key in enumerate(stage_keys):
        stage = outputs[key]
        depth_values = _f(stage["depth_values"])
        logits = _f(stage["prob_volume_pre"])
        gt = _f(depth_gt_ms[key])[:, None]
        if inverse_depth:
            depth_values = torch.flip(depth_values, dims=(1,))
            logits = torch.flip(logits, dims=(1,))
        out = ((gt < depth_values[:, 0:1]).to(gt.dtype)
               + (gt > depth_values[:, -1:]).to(gt.dtype))
        final_mask = (1.0 - out.clamp(0.0, 1.0))[:, 0] * (mask_ms[key] > 0.5).to(gt.dtype)

        D = depth_values.shape[1]
        gt_index = (depth_values[:, 1:] <= gt).to(gt.dtype).sum(dim=1).clamp(0, D - 2).long()
        gt_left = select_bin(depth_values[:, :-1], gt_index)[:, None]
        itv = select_bin((depth_values[:, 1:] - depth_values[:, :-1]).abs(), gt_index)[:, None]
        w_left = ((gt - gt_left).abs() / itv).clamp(0.0, 1.0)[:, 0]
        w_right = 1.0 - w_left
        nll_l = -select_bin(torch.log_softmax(logits[:, :-1], dim=1), gt_index)
        nll_r = -select_bin(torch.log_softmax(logits[:, 1:], dim=1), gt_index)
        loss = (((nll_l * w_left * final_mask).sum() + (nll_r * w_right * final_mask).sum())
                / (final_mask.sum() + 1e-6))
        loss_dict[key] = dlossw[i] * loss
    return loss_dict


def reg_loss_stages(outputs, depth_gt_ms, mask_ms, depth_interval,
                    dlossw=(1.0, 1.0, 1.0, 1.0), mask_out_range: bool = False,
                    inverse_depth: bool = True, stage_keys=STAGE_KEYS) -> dict:
    """Per-stage smooth-L1 between the regressed and the true depth, both
    in units of the sample's depth interval [B]. With `mask_out_range`,
    pixels whose true depth lies outside the stage's hypotheses (widened by
    half an interval at each end) are left out."""
    loss_dict = {}
    itv = _f(depth_interval)[:, None, None]
    for i, key in enumerate(stage_keys):
        stage = outputs[key]
        gt_raw = _f(depth_gt_ms[key])
        mask = mask_ms[key] > 0.5
        if mask_out_range:
            depth_values = _f(stage["depth_values"])
            if inverse_depth:
                depth_values = torch.flip(depth_values, dims=(1,))
            intervals = _half_intervals(depth_values)
            min_dv = depth_values[:, 0] - intervals[:, 0]
            max_dv = depth_values[:, -1] + intervals[:, -1]
            out = ((gt_raw < min_dv).to(gt_raw.dtype) + (gt_raw > max_dv).to(gt_raw.dtype))
            mask = mask & (out.clamp(0.0, 1.0) < 0.5)
        loss = _masked_mean(smooth_l1(_f(stage["depth"]) / itv, gt_raw / itv), mask)
        loss_dict[key] = dlossw[i] * loss
    return loss_dict


def sinkhorn_loss(depth_gt, hypo_depth, attn_weight, mask, iters: int = 10, eps: float = 1.0,
                  continuous: bool = False):
    """The entropic optimal-transport cost between each pixel's predicted
    bin distribution `attn_weight` [B, D, H, W] and its ground truth, by
    `iters` Sinkhorn iterations in the log domain, as a mask-weighted mean.

    The cost of moving mass from bin i to bin j is |i - j|. Discrete: the
    ground truth is all on the bin nearest `depth_gt` [B, H, W]. Continuous:
    it sits in a virtual bin D whose cost from bin i is the distance from i
    to the true depth's fractional bin in inverse depth (10 where the mask
    is off). The [B, HW, D, D] bin-to-bin cost is one [D, D] table
    broadcast over the pixels; the iterations are a plain loop."""
    B, D, H, W = attn_weight.shape
    pred = _f(attn_weight).permute(0, 2, 3, 1).reshape(B, H * W, D)
    dt, dev = pred.dtype, pred.device
    bins = torch.arange(D, dtype=dt, device=dev)
    base = (bins[None, :] - bins[:, None]).abs()  # [D (pred), D (gt)]
    scaled = base / eps
    log_nu = torch.log(pred + 1e-12)
    u = torch.zeros_like(log_nu)

    if not continuous:
        gt_idx = (hypo_depth - depth_gt[:, None]).abs().argmin(dim=1).reshape(B, H * W)
        log_mu = torch.log(F.one_hot(gt_idx, D).to(dt) + 1e-12)
        v = torch.zeros_like(log_mu)
        for _ in range(iters):
            v = log_mu - torch.logsumexp(scaled + u[..., :, None], dim=2)
            u = log_nu - torch.logsumexp(scaled + v[..., None, :], dim=3)
        t_map = torch.exp(scaled + u[..., :, None] + v[..., None, :])
        per_pixel = (t_map * base).sum(dim=(2, 3))
    else:
        itv = 1.0 / hypothesis(hypo_depth, 2) - 1.0 / hypothesis(hypo_depth, 1)
        gt_bin = (1.0 / depth_gt - 1.0 / hypo_depth[:, 0]) / itv
        gt_bin = torch.where(mask, gt_bin, torch.full_like(gt_bin, 10.0))
        # The virtual bin's column of the cost map: [B, HW, D].
        gcost = (gt_bin[:, None] - bins[:, None, None]).abs().permute(0, 2, 3, 1).reshape(
            B, H * W, D)
        gscaled = gcost / eps
        log_mu = torch.log(torch.cat([torch.zeros_like(u), torch.ones_like(u[..., :1])], -1)
                           + 1e-12)
        v = torch.zeros_like(log_mu)
        for _ in range(iters):
            v = log_mu - torch.cat([torch.logsumexp(scaled + u[..., :, None], dim=2),
                                    torch.logsumexp(gscaled + u, dim=2, keepdim=True)], -1)
            u = log_nu - torch.logaddexp(torch.logsumexp(scaled + v[..., None, :-1], dim=3),
                                         gscaled + v[..., -1:])
        t_map = torch.exp(scaled + u[..., :, None] + v[..., None, :-1])
        t_gt = torch.exp(gscaled + u + v[..., -1:])
        per_pixel = (t_map * base).sum(dim=(2, 3)) + (t_gt * gcost).sum(dim=2)
    return _masked_mean(per_pixel.reshape(B, H, W), mask, eps=1e-12)


def wasserstein_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw=(1.0, 1.0, 1.0, 1.0),
                            ot_iter: int = 10, ot_eps: float = 1.0, ot_continuous: bool = False,
                            stage_keys=STAGE_KEYS) -> dict:
    """Per-stage Sinkhorn loss on softmax(prob_volume_pre)."""
    loss_dict = {}
    for i, key in enumerate(stage_keys):
        stage = outputs[key]
        loss = sinkhorn_loss(_f(depth_gt_ms[key]), _f(stage["depth_values"]),
                             torch.softmax(_f(stage["prob_volume_pre"]), dim=1),
                             mask_ms[key] > 0.5, iters=ot_iter, eps=ot_eps,
                             continuous=ot_continuous)
        loss_dict[key] = dlossw[i] * loss
    return loss_dict


def simple_loss(depth_est, depth_gt, mask):
    """Single-map masked smooth-L1."""
    return _masked_mean(smooth_l1(_f(depth_est), _f(depth_gt)), mask > 0.5)


def bimodal_loss(outputs, depth_gt_ms, mask_ms, depth_interval, dlossw=(1.0, 1.0, 1.0),
                 stage_keys=("stage1", "stage2", "stage3")) -> dict:
    """Negative log-likelihood of a two-mode Laplacian mixture (each stage's
    depth0/depth1, sigma0/sigma1, pi0/pi1) in depth-interval units; the
    legacy surface, which no model emits."""
    itv = _f(depth_interval)[:, None, None]
    loss_dict = {}
    for i, key in enumerate(stage_keys):
        st = {k: _f(v) for k, v in outputs[key].items()}
        gt = _f(depth_gt_ms[key]) / itv
        dist0 = st["pi0"] * 0.5 * torch.exp(-(gt - st["depth0"] / itv).abs() / st["sigma0"]) \
            / st["sigma0"]
        dist1 = st["pi1"] * 0.5 * torch.exp(-(gt - st["depth1"] / itv).abs() / st["sigma1"]) \
            / st["sigma1"]
        nll = -torch.log(dist0 + dist1 + 1e-8)
        loss_dict[key] = dlossw[i] * _masked_mean(nll, mask_ms[key] > 0.5)
    return loss_dict


def total_loss(outputs, depth_gt_ms, mask_ms, depth_interval, depth_type: str = "ce",
               dlossw=(1.0, 1.0, 1.0, 1.0), focal: bool = False, gamma: float = 0.0,
               inverse_depth: bool = True, mask_out_range: bool = False,
               stage_keys=STAGE_KEYS):
    """-> (sum of the stage losses, {stage key: loss}), by depth type.
    `depth_interval` [B] and `mask_out_range` are read by `re` only,
    `focal` and `gamma` by `ce` only."""
    if depth_type == "re":
        loss_dict = reg_loss_stages(outputs, depth_gt_ms, mask_ms, depth_interval, dlossw,
                                    mask_out_range=mask_out_range, inverse_depth=inverse_depth,
                                    stage_keys=stage_keys)
    elif depth_type == "was":
        loss_dict = wasserstein_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw,
                                            stage_keys=stage_keys)
    elif depth_type == "ce":
        loss_dict = ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw, focal=focal,
                                   gamma=gamma, inverse_depth=inverse_depth,
                                   stage_keys=stage_keys)
    elif depth_type == "mixup_ce":
        loss_dict = mixup_ce_loss_stages(outputs, depth_gt_ms, mask_ms, dlossw,
                                         inverse_depth=inverse_depth, stage_keys=stage_keys)
    else:
        raise ValueError(f"unknown depth_type {depth_type!r}")
    return sum(loss_dict.values()), loss_dict
