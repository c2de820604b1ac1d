"""Image resizes with explicit corner-alignment semantics.

Port of `mvsformer_tpu/ops/resize.py`. The JAX package writes these as
gathers and matmuls because `jax.image.resize` lacks align_corners=True;
here `F.interpolate` is the op itself. Tensors are NCHW (any leading
layout with the two spatial axes last).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as_4d(x):
    lead = x.shape[:-2]
    return x.reshape(-1, 1, *x.shape[-2:]) if len(lead) != 2 else x, lead


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of the last two axes."""
    y, lead = _as_4d(x)
    y = F.interpolate(y, size=tuple(out_hw), mode="bilinear",
                      align_corners=align_corners)
    return y.reshape(*lead, *y.shape[-2:])


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Nearest resize of the last two axes (index floor(i * in / out))."""
    y, lead = _as_4d(x)
    y = F.interpolate(y, size=tuple(out_hw), mode="nearest")
    return y.reshape(*lead, *y.shape[-2:])


def resize_bicubic(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bicubic resize of the last two axes: half-pixel centres, a = -0.75,
    border-replicated taps (torch's align_corners=False bicubic)."""
    y, lead = _as_4d(x)
    y = F.interpolate(y, size=tuple(out_hw), mode="bicubic", align_corners=False)
    return y.reshape(*lead, *y.shape[-2:])
