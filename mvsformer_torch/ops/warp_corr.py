"""K1: plane-sweep warp + group correlation + depth entropy, all views at once.

Port of `mvsformer_tpu/ops/pallas/warp_corr.py` `plane_sweep_group_corr_v4_mv`
(and, with V = 1, `plane_sweep_group_corr_v4`). The kernel is
`csrc/warp_corr.cu`; `warp_group_corr_plain` is its plain version, built from
`geometry.homo_warp`, `correlation.groupwise_correlation` and
`correlation.entropy_over_depth` exactly as the JAX model runs them on the
CPU. `warp_group_corr` launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops import cuda_build, geometry
from mvsformer_torch.ops.correlation import entropy_over_depth, groupwise_correlation


def warp_group_corr_plain(ref, src, src_projs, ref_proj, depth_values, groups: int):
    """ref [B,H,W,C], src [B,V,H,W,C], src_projs [B,V,4,4], ref_proj [B,4,4]
    (composed), depth_values [B,D] or [B,D,H,W] ->
    (corr [B,V,G,D,H,W] f32, entropy [B,V,H,W] f32)."""
    corrs, ents = [], []
    for v in range(src.shape[1]):
        warped, _ = geometry.homo_warp(src[:, v].float(), src_projs[:, v],
                                       ref_proj, depth_values)
        corr = groupwise_correlation(ref, warped, groups)  # [B, D, H, W, G]
        ents.append(entropy_over_depth(corr)[..., 0])
        corrs.append(corr.permute(0, 4, 1, 2, 3))
    return torch.stack(corrs, 1), torch.stack(ents, 1)


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
    if groups != 8 or C not in (8, 16, 32, 64) or D > 32:
        raise ValueError(f"{what}: kernel takes groups=8, C in 8/16/32/64, D<=32; "
                         f"got groups={groups}, C={C}, D={D}")
    cuda_build.check_f32_contiguous(what, ref=ref, src=src, depth_values=depth_values)
    # Rows 0-2 of src @ inv(ref) in fp32 without TF32 (see ops/geometry.py).
    mat = geometry.relative_projection(src_projs, ref_proj[:, None])[:, :, :3, :]
    mat = mat.contiguous()
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
    return corr, ent
