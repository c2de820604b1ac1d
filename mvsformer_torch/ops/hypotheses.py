"""Depth-hypothesis initialisation and cascade scheduling.

Port of `mvsformer_tpu/ops/hypotheses.py`: the metric and inverse forms,
and the ETH3D forms that clamp the inverse-depth range. Volumes are
[B, D, H, W].
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


# The ETH3D scheduler's floor in inverse depth (depth 50), as the JAX
# `schedule_inverse_range_clamped` sets it.
ETH3D_INV_FLOOR = 0.02


def hypothesis(depth_hypo, i: int):
    """depth_hypo[:, i] with the index clamped to the last hypothesis, as
    JAX clamps a static index past the end: after a stage of 2 hypotheses
    the local interval (bins 2 and 1) is 0, so the next stage's window
    shrinks onto the previous depth."""
    return depth_hypo[:, min(i, depth_hypo.shape[1] - 1)]


def schedule_inverse_range(depth, depth_hypo, ndepths: int, split_itv: float,
                           height: int, width: int, inv_floor: float | None = None):
    """Per-pixel inverse-depth window around the previous stage's depth.

    depth [B, h, w]; depth_hypo [B, Dprev, h, w]. Returns [B, D, H, W],
    bilinearly upsampled in inverse space with align_corners=True. With
    `inv_floor` (the ETH3D scheduler, `ETH3D_INV_FLOOR`), a window whose
    far edge (its least inverse depth) falls below the floor is shifted up
    to sit on it.
    """
    last_itv = 1.0 / hypothesis(depth_hypo, 2) - 1.0 / hypothesis(depth_hypo, 1)
    inv_min = 1.0 / depth + split_itv * last_itv
    inv_max = 1.0 / depth - split_itv * last_itv
    if inv_floor is not None:
        shift = (inv_max - inv_floor) * (inv_max < inv_floor).to(depth.dtype)
        inv_max = inv_max - shift
        inv_min = inv_min - shift
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


def init_inverse_range_clamped(cur_depth, ndepths: int, height: int, width: int,
                               dmin: float = 0.01, dmax: float = 50.0):
    """The ETH3D initial hypotheses: the depth range clamped to [dmin, dmax]."""
    return init_inverse_range(cur_depth.clamp(dmin, dmax), ndepths, height, width)
