"""K3: the eval depth decode (temperature soft-argmax + confidence).

Port of `mvsformer_tpu/ops/pallas/stage_tail.py` `fused_depth_decode`:
depth = sum_d softmax(tmp * l)_d * dv_d and conf = 1 / sum_d exp(l_d - max l)
per pixel of [B, D, H, W] logits and depths. The kernel is
`csrc/depth_decode.cu` (bound by memory; its header gives the design); its
plain version is `ops/regression.decode_depth` (eval `ce`). `depth_decode`
launches the kernel for CUDA tensors and runs the plain version only for
CPU tensors.
"""

from __future__ import annotations

import torch

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.regression import decode_depth


def depth_decode_plain(logits, depth_values, tmp: float):
    """logits, depth_values [B,D,H,W] f32 -> (depth, conf) [B,H,W] f32."""
    return decode_depth(logits, depth_values, "ce", tmp)


def depth_decode(logits, depth_values, tmp: float):
    """The K3 wrapper; same arguments and results as the plain version.

    On CUDA it takes float32 contiguous [B, D, H, W] tensors, any D >= 1,
    and raises on anything else.
    """
    what = "depth_decode"
    if not cuda_build.require_cuda_inputs(what, logits, depth_values):
        return depth_decode_plain(logits, depth_values, tmp)
    if logits.dim() != 4 or logits.shape != depth_values.shape:
        raise ValueError(f"{what}: logits and depth_values must both be [B, D, H, W], "
                         f"got {tuple(logits.shape)} and {tuple(depth_values.shape)}")
    cuda_build.check_f32_contiguous(what, logits=logits, depth_values=depth_values)
    B, D, H, W = logits.shape
    depth = torch.empty((B, H, W), dtype=torch.float32, device=logits.device)
    conf = torch.empty_like(depth)
    lib = cuda_build.library("depth_decode")
    # The runtime launches on the current device, so the stream's device is
    # made current for the call.
    with torch.cuda.device(logits.device):
        rc = lib.depth_decode_f32(logits.data_ptr(), depth_values.data_ptr(), depth.data_ptr(),
                                  conf.data_ptr(), B, D, H * W, tmp,
                                  torch.cuda.current_stream(logits.device).cuda_stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, (depth, conf), logits, depth_values)
