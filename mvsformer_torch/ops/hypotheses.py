"""Depth-hypothesis initialisation and cascade scheduling.

Port of `mvsformer_tpu/ops/hypotheses.py` (the metric and inverse forms;
the ETH3D clamped forms come with a later slice). Volumes are [B, D, H, W].
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops.resize import resize_bilinear


def init_range(cur_depth, ndepths: int, height: int, width: int):
    """Uniform metric-depth hypotheses [B, D, H, W] from a [B, Dfull] range."""
    dmin = cur_depth[:, 0]
    dmax = cur_depth[:, -1]
    itv = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, dtype=cur_depth.dtype, device=cur_depth.device)
    samples = dmin[:, None] + steps[None, :] * itv[:, None]
    return samples[:, :, None, None].expand(-1, -1, height, width).contiguous()


def init_inverse_range(cur_depth, ndepths: int, height: int, width: int):
    """Uniform inverse-depth hypotheses [B, D, H, W]; bin 0 sits at 1/d_max,
    so depths come out descending."""
    inv_min = 1.0 / cur_depth[:, 0]
    inv_max = 1.0 / cur_depth[:, -1]
    itv = torch.arange(ndepths, dtype=cur_depth.dtype,
                       device=cur_depth.device) / (ndepths - 1)
    inv_hypo = inv_max[:, None] + (inv_min - inv_max)[:, None] * itv[None, :]
    hypo = 1.0 / inv_hypo
    return hypo[:, :, None, None].expand(-1, -1, height, width).contiguous()


def schedule_inverse_range(depth, depth_hypo, ndepths: int, split_itv: float,
                           height: int, width: int):
    """Per-pixel inverse-depth window around the previous stage's depth.

    depth [B, h, w]; depth_hypo [B, Dprev, h, w]. Returns [B, D, H, W],
    bilinearly upsampled in inverse space with align_corners=True.
    """
    last_itv = 1.0 / depth_hypo[:, 2] - 1.0 / depth_hypo[:, 1]
    inv_min = 1.0 / depth + split_itv * last_itv
    inv_max = 1.0 / depth - split_itv * last_itv
    itv = torch.arange(ndepths, dtype=depth.dtype, device=depth.device) / (ndepths - 1)
    inv_hypo = inv_max[:, None] + (inv_min - inv_max)[:, None] * itv[None, :, None, None]
    inv_hypo = resize_bilinear(inv_hypo, (height, width), align_corners=True)
    return 1.0 / inv_hypo


def schedule_range(cur_depth, ndepths: int, depth_interval_pixel,
                   height: int, width: int):
    """Metric window +-D/2*interval around the previous depth, clamped at
    0.01; `depth_interval_pixel` is [B]."""
    dmin = cur_depth - ndepths / 2 * depth_interval_pixel[:, None, None]
    dmin = torch.clamp_min(dmin, 0.01)
    dmax = cur_depth + ndepths / 2 * depth_interval_pixel[:, None, None]
    itv = (dmax - dmin) / (ndepths - 1)
    steps = torch.arange(ndepths, dtype=cur_depth.dtype, device=cur_depth.device)
    samples = dmin[:, None] + steps[None, :, None, None] * itv[:, None]
    return resize_bilinear(samples, (height, width), align_corners=True)
