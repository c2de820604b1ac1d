"""K5: one top-down FPN level (up2 + lateral 1x1 + 3x3 conv + BN + swish).

Port of `mvsformer_tpu/ops/pallas/fpn_final.py` `fpn_level` (and its
`fpn_final_level`) and of `mvsformer_tpu/ops/pallas/fpn_up.py`
`fpn_up_level`, which compute the same level:

    intra' = up2(intra_prev) + conv1x1(lateral) + b1
    out    = swish(BN(conv3x3(intra') + b3))

with up2 the 2x bilinear resize with align_corners=True. The kernel is
`csrc/fpn_level.cu`; `fpn_level_plain` is its plain version, exactly one
level of `FPNDecoder`. `fpn_level` launches the kernel for CUDA tensors and
runs the plain version only for CPU tensors.

The kernel runs the 3x3 conv on the tensor cores in 3xTF32: each operand is
split into hi = tf32(x) and lo = tf32(x - hi), and each product summed as
lo*hi + hi*lo + hi*hi in fp32, which keeps fp32's accuracy. `pack_k3` is
the plain helper the wrapper splits and packs the 3x3 weights with, on the
weights' device; it and `tf32_round` / `split_tf32` live in `ops/tf32.py`
and are exported here under their old names.

Weights are torch layout: w1 [64,cl,1,1], b1 [64], k3 [co,64,3,3], b3 [co];
`fold` is the folded BN (mul, add) [co]. The kernel takes
(cl, co) in {(32, 32), (16, 16), (8, 8)}, the three levels of the decoder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.models.blocks import swish
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.resize import resize_bilinear
from mvsformer_torch.ops.tf32 import pack_conv3x3, split_tf32, tf32_round  # noqa: F401

LEVELS = ((32, 32), (16, 16), (8, 8))  # (cl, co) the kernel is built for


def fpn_level_plain(intra_prev, lateral, w1, b1, k3, b3, fold, emit_intra: bool = False):
    """intra_prev [N,64,h,w], lateral [N,cl,2h,2w] -> out [N,co,2h,2w], and
    with emit_intra also intra' [N,64,2h,2w]."""
    mul, add = fold
    h, w = intra_prev.shape[-2:]
    intra = (resize_bilinear(intra_prev, (2 * h, 2 * w), align_corners=True)
             + F.conv2d(lateral, w1, b1))
    y = F.conv2d(intra, k3, b3, padding=1)
    out = swish(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1))
    return (out, intra) if emit_intra else out


def pack_k3(k3):
    """k3 [co,64,3,3] -> its TF32 hi and lo parts in mma.m16n8k8 B-fragment
    order, [8 chunks, 9 taps, co/8, 32 lanes, 4] (`ops/tf32.pack_conv3x3`)."""
    return pack_conv3x3(k3)


def fpn_level(intra_prev, lateral, w1, b1, k3, b3, fold, emit_intra: bool = False):
    """The K5 wrapper; same arguments and results as the plain version."""
    what = "fpn_level"
    mul, add = fold
    if not cuda_build.require_cuda_inputs(what, intra_prev, lateral, w1, b1, k3, b3,
                                          mul, add):
        return fpn_level_plain(intra_prev, lateral, w1, b1, k3, b3, fold, emit_intra)
    if intra_prev.dim() != 4 or intra_prev.shape[1] != 64:
        raise ValueError(f"{what}: intra_prev must be [N, 64, h, w], "
                         f"got {tuple(intra_prev.shape)}")
    N, _, h, w = intra_prev.shape
    cl, co = w1.shape[1], k3.shape[0]
    if (cl, co) not in LEVELS:
        raise ValueError(f"{what}: (cl, co) must be one of {LEVELS}, got {(cl, co)}")
    if tuple(lateral.shape) != (N, cl, 2 * h, 2 * w):
        raise ValueError(f"{what}: lateral must be {(N, cl, 2 * h, 2 * w)}, "
                         f"got {tuple(lateral.shape)}")
    for key, t, shape in (("w1", w1, (64, cl, 1, 1)), ("b1", b1, (64,)),
                          ("k3", k3, (co, 64, 3, 3)), ("b3", b3, (co,)),
                          ("mul", mul, (co,)), ("add", add, (co,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {key} must be {shape}, got {tuple(t.shape)}")
    cuda_build.check_f32_contiguous(what, intra_prev=intra_prev, lateral=lateral)
    # w1 as [c][l] (a channel's lateral weights contiguous: float4 reads),
    # then the biases and the BN fold; k3 split and packed for the mma.
    params = torch.cat([t.float().reshape(-1) for t in (w1, b1, b3, mul, add)])
    wpk = pack_k3(k3)
    H, W = 2 * h, 2 * w
    out = torch.empty((N, co, H, W), dtype=torch.float32, device=intra_prev.device)
    intra = (torch.empty((N, 64, H, W), dtype=torch.float32, device=intra_prev.device)
             if emit_intra else None)
    lib = cuda_build.library("fpn_level")
    with torch.cuda.device(intra_prev.device):
        stream = torch.cuda.current_stream(intra_prev.device).cuda_stream
        rc = lib.fpn_level_f32(intra_prev.data_ptr(), lateral.data_ptr(), params.data_ptr(),
                               wpk.data_ptr(), out.data_ptr(),
                               0 if intra is None else intra.data_ptr(),
                               N, h, w, cl, co, stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, (out, intra) if emit_intra else out,
                                   intra_prev, lateral, w1, b1, k3, b3, mul, add)
