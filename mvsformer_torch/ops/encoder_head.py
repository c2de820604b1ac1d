"""K4: the FPN encoder head (conv00 -> conv01 -> downsample1) in one launch.

Port of `mvsformer_tpu/ops/pallas/encoder_head.py` `encoder_head`. The
kernel is `csrc/encoder_head.cu`; `encoder_head_plain` is its plain version,
exactly `FPNEncoder`'s first three `ConvNormAct`s: a 7x7 conv 3 -> 8, a 5x5
conv 8 -> 8 and a 5x5 stride-2 conv 8 -> 16, each without bias, with folded
BN and leaky-ReLU 0.1. `encoder_head` launches the kernel for CUDA tensors
and runs the plain version only for CPU tensors. The kernel runs all three
convs on the tensor cores in 3xTF32. Before it, the wrapper launches the
source's pack kernel, which splits the weights to TF32 hi and lo parts in
mma B-fragment order on the device, in one launch; `pack_plain` is the
same layout on the CPU, its oracle.

Weights are torch layout: k00 [8,3,7,7], k01 [8,8,5,5], kd [16,8,5,5];
each fold is that layer's folded BN (mul, add) [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.tf32 import pack_conv, pack_conv_rows

_SHAPES = {"k00": (8, 3, 7, 7), "k01": (8, 8, 5, 5), "kd": (16, 8, 5, 5)}
# Floats of the packed weights: the six folded-BN vectors (8, 8, 8, 8, 16,
# 16), then the B fragments of conv00 (7 rows x 3 chunks), conv01 (25 taps)
# and down0 (25 taps x 2 N fragments), 4 x 32 lanes each.
PACKED_FLOATS = 64 + 4 * 32 * (7 * 3 + 25 + 25 * 2)


def _conv_norm_lrelu(x, k, fold, stride):
    mul, add = fold
    y = F.conv2d(x, k, stride=stride, padding=(k.shape[-1] - 1) // 2)
    return F.leaky_relu(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1), 0.1)


def encoder_head_plain(imgs, k00, fold00, k01, fold01, kd, foldd):
    """imgs [N, 3, H, W] f32 -> (conv01 [N, 8, H, W], down0 [N, 16, ceil(H/2), ceil(W/2)])."""
    conv01 = _conv_norm_lrelu(_conv_norm_lrelu(imgs, k00, fold00, 1), k01, fold01, 1)
    return conv01, _conv_norm_lrelu(conv01, kd, foldd, 2)


def pack_plain(k00, fold00, k01, fold01, kd, foldd):
    """The packed weights as the device pack kernel writes them
    ([PACKED_FLOATS]): the folded BNs, then conv00's TF32 parts in the
    layout of `ops/tf32.pack_conv_rows` and conv01's and down0's in that of
    `ops/tf32.pack_conv`."""
    return torch.cat([t.float().reshape(-1) for t in (
        *fold00, *fold01, *foldd, pack_conv_rows(k00), pack_conv(k01), pack_conv(kd))])


def encoder_head(imgs, k00, fold00, k01, fold01, kd, foldd):
    """The K4 wrapper; same arguments and results as the plain version."""
    what = "encoder_head"
    folds = (*fold00, *fold01, *foldd)
    if not cuda_build.require_cuda_inputs(what, imgs, k00, k01, kd, *folds):
        return encoder_head_plain(imgs, k00, fold00, k01, fold01, kd, foldd)
    if imgs.dim() != 4 or imgs.shape[1] != 3:
        raise ValueError(f"{what}: imgs must be [N, 3, H, W], got {tuple(imgs.shape)}")
    for key, t in (("k00", k00), ("k01", k01), ("kd", kd)):
        if tuple(t.shape) != _SHAPES[key]:
            raise ValueError(f"{what}: {key} must be {_SHAPES[key]}, got {tuple(t.shape)}")
    for (mul, add), c in ((fold00, 8), (fold01, 8), (foldd, 16)):
        if tuple(mul.shape) != (c,) or tuple(add.shape) != (c,):
            raise ValueError(f"{what}: folded BN vectors must be [{c}]")
    cuda_build.check_f32_contiguous(what, imgs=imgs, k00=k00, k01=k01, kd=kd,
                                    **{f"fold {i}": t for i, t in enumerate(folds)})
    lib = cuda_build.library("encoder_head")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        out = launch(lib, imgs, pack(lib, k00, fold00, k01, fold01, kd, foldd, stream), stream)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, out, imgs, k00, k01, kd, *folds)


def pack(lib, k00, fold00, k01, fold01, kd, foldd, stream):
    """The weights as the kernel reads them ([PACKED_FLOATS], written by
    `encoder_head_pack_f32` from `lib` on `stream`; `pack_plain`'s layout)."""
    packed = torch.empty(PACKED_FLOATS, dtype=torch.float32, device=k00.device)
    rc = lib.encoder_head_pack_f32(*(t.data_ptr() for t in (
        k00, *fold00, k01, *fold01, kd, *foldd, packed)), stream)
    cuda_build.check_launch(rc, "encoder_head (pack)")
    return packed


def launch(lib, imgs, packed, stream):
    """One launch of `encoder_head_f32` from `lib` on `stream`; raises if it
    was refused."""
    N, _, H, W = imgs.shape
    conv01 = torch.empty((N, 8, H, W), dtype=torch.float32, device=imgs.device)
    down0 = torch.empty((N, 16, (H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                        device=imgs.device)
    rc = lib.encoder_head_f32(imgs.data_ptr(), packed.data_ptr(), conv01.data_ptr(),
                              down0.data_ptr(), N, H, W, stream)
    cuda_build.check_launch(rc, "encoder_head")
    return conv01, down0
