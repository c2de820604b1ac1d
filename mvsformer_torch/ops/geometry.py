"""Projective geometry for plane-sweep multi-view stereo.

Port of `mvsformer_tpu/ops/geometry.py`. Feature maps at these public
functions keep the JAX layout ([B, H, W, C]) so the tests compare like with
like; the model hands them channels-last views of its NCHW maps.

The coordinate maths runs in true fp32: every small matrix product here is
written out as elementwise multiply-adds, so no TF32 tensor-core pass can
touch pixel coordinates (~1e3 in magnitude, sub-0.01 accuracy needed for the
bilinear taps) whatever `torch.backends.cuda.matmul.allow_tf32` says.
"""

from __future__ import annotations

import torch


def _matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, k] @ [..., k, m] as a broadcast multiply-sum (no TF32)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def compose_projection(proj: torch.Tensor) -> torch.Tensor:
    """Fold the intrinsics into the extrinsic: [..., 2, 4, 4] -> [..., 4, 4].

    Slot 0 holds the 4x4 world->camera extrinsic, slot 1 the 3x3 intrinsic
    K in its upper-left block; the result has `K @ [R|t]` in its top rows.
    """
    ext = proj[..., 0, :, :]
    intr = proj[..., 1, :3, :3]
    top = _matmul_fp32(intr, ext[..., :3, :])
    return torch.cat([top, ext[..., 3:, :]], dim=-2)


def relative_projection(src_proj: torch.Tensor, ref_proj: torch.Tensor) -> torch.Tensor:
    """`src_proj @ inv(ref_proj)` in fp32; [..., 4, 4] each (ref broadcasts)."""
    inv = torch.linalg.inv(ref_proj.float())
    return _matmul_fp32(src_proj.float(), inv)


def plane_sweep_coords(src_proj, ref_proj, depth_values, height: int, width: int):
    """Source-view sampling coordinates for every (depth, pixel) pair.

    src_proj/ref_proj: [B, 4, 4] composed projections; depth_values: [B, D]
    or [B, D, H, W]. Returns (px, py) [B, D, H*W] (align-corners pixel
    coordinates) and the [B, D, H, W] bool mask of projections outside the
    source frustum or behind the camera.
    """
    B = src_proj.shape[0]
    D = depth_values.shape[1]
    proj = relative_projection(src_proj, ref_proj)
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]
    dev = proj.device
    y, x = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                          torch.arange(width, dtype=torch.float32, device=dev),
                          indexing="ij")
    x = x.reshape(1, 1, -1)
    y = y.reshape(1, 1, -1)
    rot_xyz = rot[:, :, 0:1] * x + rot[:, :, 1:2] * y + rot[:, :, 2:3]  # [B,3,HW]
    depth = depth_values.float().reshape(B, 1, D, -1)
    proj_xyz = rot_xyz[:, :, None, :] * depth + trans[:, :, None, None]
    z = proj_xyz[:, 2]
    px = proj_xyz[:, 0] / (z + 1e-6)
    py = proj_xyz[:, 1] / (z + 1e-6)
    x_out = (px < 0.0) | (px > width - 1)
    y_out = (py < 0.0) | (py > height - 1)
    invalid = (x_out | y_out | (z <= 0.0)).reshape(B, D, height, width)
    return px, py, invalid


def bilinear_sample(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample `src` [B, H, W, C] at pixel coords px/py [B, N].

    grid_sample semantics with padding_mode='zeros' and align_corners=True:
    out-of-bounds taps contribute zero. Returns [B, N, C].
    """
    B, H, W, C = src.shape
    src_flat = src.reshape(B, H * W, C)
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = px - x0
    wy = py - y0
    batch = torch.arange(B, device=src.device)[:, None]
    out = None
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
            tap = src_flat[batch, idx]  # [B, N, C]
            w = (wgt_x * wgt_y * valid).to(src.dtype)[..., None]
            out = tap * w if out is None else out + tap * w
    return out


def homo_warp(src_fea, src_proj, ref_proj, depth_values):
    """Plane-sweep warp of source features onto the reference hypotheses.

    src_fea [B, H, W, C]; projections [B, 4, 4]; depth_values [B, D] or
    [B, D, H, W]. Returns ([B, D, H, W, C] warped volume, [B, D, H, W] mask).
    """
    B, H, W, C = src_fea.shape
    D = depth_values.shape[1]
    with torch.no_grad():
        px, py, invalid = plane_sweep_coords(src_proj, ref_proj, depth_values, H, W)
    warped = bilinear_sample(src_fea, px.reshape(B, -1), py.reshape(B, -1))
    return warped.reshape(B, D, H, W, C), invalid
