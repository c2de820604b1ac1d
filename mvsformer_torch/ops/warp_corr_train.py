"""K8 and the training warp: K7 forward, K8 backward, as one autograd Function.

Port of `mvsformer_tpu/ops/pallas/warp_corr_train.py` `fused_warp_corr_train`
(the custom_vjp wiring) and of `mvsformer_tpu/ops/pallas/warp_corr_bwd.py`
`plane_sweep_group_corr_bwd` (K8, `csrc/warp_corr_bwd.cu`).

The contract is the exact, unclipped XLA path the JAX model runs on the CPU:
`geometry.homo_warp` then `correlation.groupwise_correlation`, and its
backward is the exact VJP of that path in the two feature arguments (the
JAX `native_bwd=False` branch). The TPU band windows, the v4 -> v3 remap's
mask and the `ok` gating of the JAX custom_vjp are not part of it.
Projections and depths get no gradient, as the JAX backward returns zeros
for them.

`warp_corr_bwd_plain` is K8's plain version: autograd through the plain
forward, recomputed. `warp_corr_bwd` launches K8 for CUDA tensors and runs
the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.warp_corr import (_check_warp_inputs, relative_rows,
                                           warp_corr_fwd, warp_corr_fwd_plain)


def warp_corr_bwd_plain(ref, src, src_projs, ref_proj, depth_values, dcorr, groups: int):
    """K7's inputs and dcorr [B,V,G,D,H,W] -> (dref [B,H,W,C], dsrc [B,V,H,W,C])."""
    with torch.enable_grad():
        ref = ref.detach().requires_grad_()
        src = src.detach().requires_grad_()
        corr = warp_corr_fwd_plain(ref, src, src_projs, ref_proj, depth_values, groups)
        dref, dsrc = torch.autograd.grad(corr, (ref, src), dcorr)
    return dref, dsrc


def warp_corr_bwd(ref, src, src_projs, ref_proj, depth_values, dcorr, groups: int = 8):
    """The K8 wrapper; same arguments and results as the plain version.

    On CUDA it takes what K7 takes, and dcorr as a float32 contiguous
    [B, V, G, D, H, W] tensor; it raises on anything else.
    """
    what = "warp_corr_bwd"
    if not cuda_build.require_cuda_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values, dcorr):
        return warp_corr_bwd_plain(ref, src, src_projs, ref_proj, depth_values, dcorr, groups)
    B, V, D, H, W, C = _check_warp_inputs(what, ref, src, src_projs, ref_proj,
                                          depth_values, groups)
    if tuple(dcorr.shape) != (B, V, groups, D, H, W):
        raise ValueError(f"{what}: dcorr must be {(B, V, groups, D, H, W)}, "
                         f"got {tuple(dcorr.shape)}")
    cuda_build.check_f32_contiguous(what, dcorr=dcorr)
    mat = relative_rows(src_projs, ref_proj)
    dref = torch.zeros_like(ref)
    dsrc = torch.zeros_like(src)
    lib = cuda_build.library("warp_corr_bwd")
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.warp_corr_bwd_f32(
            ref.data_ptr(), src.data_ptr(), mat.data_ptr(), depth_values.data_ptr(),
            dcorr.data_ptr(), dref.data_ptr(), dsrc.data_ptr(), B, V, D, H, W, C, groups,
            stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return dref, dsrc


class WarpCorrTrain(torch.autograd.Function):
    """corr [B,V,G,D,H,W] = K7(ref, src, src_projs, ref_proj, depth_values),
    differentiable in ref and src through K8.

    The forward saves only its inputs: the backward recomputes the taps, and
    the warped volume never exists.
    """

    @staticmethod
    def forward(ctx, ref, src, src_projs, ref_proj, depth_values, groups: int = 8):
        ctx.groups = groups
        ctx.save_for_backward(ref, src, src_projs, ref_proj, depth_values)
        corr = warp_corr_fwd(ref, src, src_projs, ref_proj, depth_values, groups)
        return corr

    @staticmethod
    def backward(ctx, dcorr):
        ref, src, src_projs, ref_proj, depth_values = ctx.saved_tensors
        dref, dsrc = warp_corr_bwd(ref, src, src_projs, ref_proj, depth_values,
                                   dcorr.contiguous(), ctx.groups)
        return dref, dsrc, None, None, None, None

