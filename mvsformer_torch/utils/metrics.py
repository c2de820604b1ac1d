"""Depth-map evaluation metrics, on tensors.

Port of `mvsformer_tpu/utils/metrics.py`: per-image masked threshold-error
rates and absolute depth error, averaged over the batch, as mask-weighted
means. They run where their inputs lie (the card, in `save_depth`).
"""

from __future__ import annotations

import torch


def _per_image_masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over masked pixels per image, then mean over the batch."""
    mask = mask.to(x.dtype)
    dims = tuple(range(1, x.dim()))
    per_img = (x * mask).sum(dims) / (mask.sum(dims) + 1e-12)
    return per_img.mean()


def thres_metric(depth_est, depth_gt, mask, thres: float) -> torch.Tensor:
    """Share of masked pixels with |error| > thres."""
    err = (depth_est - depth_gt).abs()
    return _per_image_masked_mean((err > thres).float(), mask)


def abs_depth_error(depth_est, depth_gt, mask, thres=None) -> torch.Tensor:
    """Masked mean |error|, optionally only over errors in [thres[0], thres[1]]."""
    err = (depth_est - depth_gt).abs()
    m = mask.bool()
    if thres is not None:
        m = m & (err >= float(thres[0])) & (err <= float(thres[1]))
    return _per_image_masked_mean(err, m)


def depth_metrics(depth_est, depth_gt, mask, di: float) -> dict:
    """The DTU depth-metric suite: the absolute error (errors up to 10) and
    the threshold rates at {1, 2, 4, 8, 14, 20} * di, di = depth_interval /
    2.65."""
    out = {"abs_depth_error": abs_depth_error(depth_est, depth_gt, mask, thres=[0.0, 10.0])}
    for k in (1, 2, 4, 8, 14, 20):
        out[f"thres{k}mm_error"] = thres_metric(depth_est, depth_gt, mask, k * di)
    return out


def validation_metrics(depth_est, depth_gt, mask, di: float) -> dict:
    """The validation metrics; `mean_error`, the mean of the 2/4/8/14 rates,
    picks the best checkpoint."""
    m = {
        "abs_error": abs_depth_error(depth_est, depth_gt, mask),
        "thres2mm_error": thres_metric(depth_est, depth_gt, mask, 2 * di),
        "thres4mm_error": thres_metric(depth_est, depth_gt, mask, 4 * di),
        "thres8mm_error": thres_metric(depth_est, depth_gt, mask, 8 * di),
        "thres14mm_error": thres_metric(depth_est, depth_gt, mask, 14 * di),
    }
    m["mean_error"] = (m["thres2mm_error"] + m["thres4mm_error"] + m["thres8mm_error"]
                       + m["thres14mm_error"]) / 4.0
    return m
