"""K3: the eval depth decode (temperature soft-argmax + confidence), Triton.

Port of `mvsformer_tpu/ops/pallas/stage_tail.py` `fused_depth_decode`:
depth = sum_d softmax(tmp * l)_d * dv_d and conf = 1 / sum_d exp(l_d - max l)
per pixel of [B, D, H, W] logits and depths. Its plain version is
`ops/regression.decode_depth` (eval `ce`). `depth_decode` launches the
Triton kernel for CUDA tensors and runs the plain version only for CPU
tensors.

Bound on the H100: memory. Per pixel it reads 2*D floats and writes 2; the
arithmetic is a handful of exps per read.

Design: one program per block of 1024 pixels of one batch entry; loads run
along W, so they are coalesced. A first pass over D takes the max; a second
computes sum exp(l - m), sum exp(tmp (l - m)) and sum exp(tmp (l - m)) * dv
in registers (the second read of the logits mostly hits L2). `triton` is
imported on first launch, never at module import.
"""

from __future__ import annotations

import os

import torch

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.regression import decode_depth

BLOCK = 1024
_KERNELS: dict = {}


def depth_decode_plain(logits, depth_values, tmp: float):
    """logits, depth_values [B,D,H,W] f32 -> (depth, conf) [B,H,W] f32."""
    return decode_depth(logits, depth_values, "ce", tmp)


def _triton_kernel():
    kernel = _KERNELS.get("decode")
    if kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(cuda_build.BUILD_DIR / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def _decode(l_ptr, d_ptr, depth_ptr, conf_ptr, HW, tmp,
                    D: tl.constexpr, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            b = tl.program_id(1)
            offs = pid * BLOCK + tl.arange(0, BLOCK)
            mask = offs < HW
            base = b * D * HW
            m = tl.load(l_ptr + base + offs, mask=mask, other=0.0)
            for d in tl.static_range(1, D):
                m = tl.maximum(m, tl.load(l_ptr + base + d * HW + offs, mask=mask, other=0.0))
            s1 = tl.zeros([BLOCK], dtype=tl.float32)
            st = tl.zeros([BLOCK], dtype=tl.float32)
            ws = tl.zeros([BLOCK], dtype=tl.float32)
            for d in tl.static_range(D):
                x = tl.load(l_ptr + base + d * HW + offs, mask=mask, other=0.0) - m
                s1 += tl.exp(x)
                et = tl.exp(tmp * x)
                st += et
                ws += et * tl.load(d_ptr + base + d * HW + offs, mask=mask, other=0.0)
            tl.store(depth_ptr + b * HW + offs, ws / st, mask=mask)
            tl.store(conf_ptr + b * HW + offs, 1.0 / s1, mask=mask)

        kernel = _KERNELS["decode"] = _decode
    return kernel


def depth_decode(logits, depth_values, tmp: float):
    """The K3 wrapper; same arguments and results as the plain version."""
    what = "depth_decode"
    if not cuda_build.require_cuda_inputs(what, logits, depth_values):
        return depth_decode_plain(logits, depth_values, tmp)
    if logits.dim() != 4 or logits.shape != depth_values.shape:
        raise ValueError(f"{what}: logits and depth_values must both be [B, D, H, W], "
                         f"got {tuple(logits.shape)} and {tuple(depth_values.shape)}")
    cuda_build.check_f32_contiguous(what, logits=logits, depth_values=depth_values)
    B, D, H, W = logits.shape
    if B * D * H * W >= 2 ** 31:
        raise ValueError(f"{what}: volume too large for 32-bit offsets")
    depth = torch.empty((B, H, W), dtype=torch.float32, device=logits.device)
    conf = torch.empty_like(depth)
    grid = (-(-(H * W) // BLOCK), B)
    with torch.cuda.device(logits.device):
        _triton_kernel()[grid](logits, depth_values, depth, conf, H * W, float(tmp),
                               D=D, BLOCK=BLOCK, num_warps=4)
    cuda_build.LAUNCHES[what] += 1
    return depth, conf

