"""K1 and K7: plane-sweep warp + group correlation, all views at once.

K1 `warp_group_corr` is the port of `mvsformer_tpu/ops/pallas/warp_corr.py`
`plane_sweep_group_corr_v4_mv` (and, with V = 1, `plane_sweep_group_corr_v4`):
the correlation and the depth entropy, for the eval forward. K7
`warp_corr_fwd` is the port of `plane_sweep_group_corr_v3`, the training
forward, and of `plane_sweep_group_corr_v2` and `plane_sweep_group_corr`
(v1), which have v3's contract with wider bands: the correlation without
the entropy. Both kernels live in
`csrc/warp_corr.cu`. Their plain versions are built from `geometry.homo_warp`,
`correlation.groupwise_correlation` and `correlation.entropy_over_depth`
exactly as the JAX model runs them on the CPU. Each wrapper launches its
kernel for CUDA tensors and runs the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops import cuda_build, geometry
from mvsformer_torch.ops.correlation import entropy_over_depth, groupwise_correlation


def warp_corr_fwd_plain(ref, src, src_projs, ref_proj, depth_values, groups: int):
    """ref [B,H,W,C], src [B,V,H,W,C], src_projs [B,V,4,4], ref_proj [B,4,4]
    (composed), depth_values [B,D] or [B,D,H,W] -> corr [B,V,G,D,H,W]:
    fp32, or fp64 for fp64 features."""
    corrs = []
    for v in range(src.shape[1]):
        warped, _ = geometry.homo_warp(src[:, v], src_projs[:, v], ref_proj, depth_values)
        corrs.append(groupwise_correlation(ref, warped, groups).permute(0, 4, 1, 2, 3))
    return torch.stack(corrs, 1)


def warp_group_corr_plain(ref, src, src_projs, ref_proj, depth_values, groups: int):
    """The K7 plain version's arguments -> (corr [B,V,G,D,H,W] f32,
    entropy [B,V,H,W] f32)."""
    corr = warp_corr_fwd_plain(ref, src, src_projs, ref_proj, depth_values, groups)
    ent = torch.stack([entropy_over_depth(corr[:, v].permute(0, 2, 3, 4, 1))[..., 0]
                       for v in range(corr.shape[1])], 1)
    return corr, ent


def _check_warp_inputs(what, ref, src, src_projs, ref_proj, depth_values, groups, max_d=None):
    """Raise unless the shapes are ones the warp kernels take (D <= max_d
    where the kernel bounds it); return (B, V, D, H, W, C)."""
    B, V, H, W, C = src.shape
    if depth_values.dim() != 4 or depth_values.shape[0] != B or \
            tuple(depth_values.shape[2:]) != (H, W):
        raise ValueError(f"{what}: depth_values must be [B, D, H, W], got "
                         f"{tuple(depth_values.shape)}")
    D = depth_values.shape[1]
    if tuple(ref.shape) != (B, H, W, C) or tuple(src_projs.shape) != (B, V, 4, 4) \
            or tuple(ref_proj.shape) != (B, 4, 4):
        raise ValueError(f"{what}: shapes ref {tuple(ref.shape)}, src_projs "
                         f"{tuple(src_projs.shape)}, ref_proj {tuple(ref_proj.shape)} "
                         f"do not match src {tuple(src.shape)}")
    if groups != 8 or C not in (8, 16, 32, 64) or (max_d is not None and D > max_d):
        bound = "" if max_d is None else f", D<={max_d}"
        raise ValueError(f"{what}: kernel takes groups=8, C in 8/16/32/64{bound}; "
                         f"got groups={groups}, C={C}, D={D}")
    cuda_build.check_f32_contiguous(what, ref=ref, src=src, depth_values=depth_values)
    return B, V, D, H, W, C


def relative_rows(src_projs, ref_proj):
    """Rows 0-2 of src @ inv(ref), [B, V, 3, 4], in fp32 without TF32 (see
    ops/geometry.py): the kernels compute px, py, z from them."""
    return geometry.relative_projection(src_projs, ref_proj[:, None])[:, :, :3, :].contiguous()


def warp_group_corr(ref, src, src_projs, ref_proj, depth_values, groups: int = 8):
    """The K1 wrapper; same arguments and results as the plain version.

    On CUDA it takes float32 contiguous tensors, pixelwise depth
    [B, D, H, W] with D <= 32, C in {8, 16, 32, 64} and groups == 8, and
    raises on anything else.
    """
    what = "warp_group_corr"
    if not cuda_build.require_cuda_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values):
        return warp_group_corr_plain(ref, src, src_projs, ref_proj, depth_values, groups)
    B, V, D, H, W, C = _check_warp_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values, groups, 32)
    mat = relative_rows(src_projs, ref_proj)
    corr = torch.empty((B, V, groups, D, H, W), dtype=torch.float32, device=src.device)
    ent = torch.empty((B, V, H, W), dtype=torch.float32, device=src.device)
    lib = cuda_build.library("warp_corr")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.warp_group_corr_f32(
            ref.data_ptr(), src.data_ptr(), mat.data_ptr(), depth_values.data_ptr(),
            corr.data_ptr(), ent.data_ptr(), B, V, D, H, W, C, groups, stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, (corr, ent), ref, src, src_projs, ref_proj,
                                   depth_values)


def warp_corr_fwd(ref, src, src_projs, ref_proj, depth_values, groups: int = 8):
    """The K7 wrapper; same arguments and results as the plain version.

    On CUDA it takes float32 contiguous tensors, pixelwise depth
    [B, D, H, W], C in {8, 16, 32, 64} and groups == 8, and raises on
    anything else.
    """
    what = "warp_corr_fwd"
    if not cuda_build.require_cuda_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values):
        return warp_corr_fwd_plain(ref, src, src_projs, ref_proj, depth_values, groups)
    B, V, D, H, W, C = _check_warp_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values, groups)
    mat = relative_rows(src_projs, ref_proj)
    corr = torch.empty((B, V, groups, D, H, W), dtype=torch.float32, device=src.device)
    lib = cuda_build.library("warp_corr")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.warp_corr_fwd_f32(
            ref.data_ptr(), src.data_ptr(), mat.data_ptr(), depth_values.data_ptr(),
            corr.data_ptr(), B, V, D, H, W, C, groups, stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return corr
