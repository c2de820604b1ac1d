"""K4: the FPN encoder head (conv00 -> conv01 -> downsample1) in one launch.

Port of `mvsformer_tpu/ops/pallas/encoder_head.py` `encoder_head`. The
kernel is `csrc/encoder_head.cu`; `encoder_head_plain` is its plain version,
exactly `FPNEncoder`'s first three `ConvNormAct`s: a 7x7 conv 3 -> 8, a 5x5
conv 8 -> 8 and a 5x5 stride-2 conv 8 -> 16, each without bias, with folded
BN and leaky-ReLU 0.1. `encoder_head` launches the kernel for CUDA tensors
and runs the plain version only for CPU tensors.

Weights are torch layout: k00 [8,3,7,7], k01 [8,8,5,5], kd [16,8,5,5];
each fold is that layer's folded BN (mul, add) [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.ops import cuda_build

_SHAPES = {"k00": (8, 3, 7, 7), "k01": (8, 8, 5, 5), "kd": (16, 8, 5, 5)}


def _conv_norm_lrelu(x, k, fold, stride):
    mul, add = fold
    y = F.conv2d(x, k, stride=stride, padding=(k.shape[-1] - 1) // 2)
    return F.leaky_relu(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1), 0.1)


def encoder_head_plain(imgs, k00, fold00, k01, fold01, kd, foldd):
    """imgs [N, 3, H, W] f32 -> (conv01 [N, 8, H, W], down0 [N, 16, ceil(H/2), ceil(W/2)])."""
    conv01 = _conv_norm_lrelu(_conv_norm_lrelu(imgs, k00, fold00, 1), k01, fold01, 1)
    return conv01, _conv_norm_lrelu(conv01, kd, foldd, 2)


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
    cuda_build.check_f32_contiguous(what, imgs=imgs)
    # Conv weights as [ci][ky][kx][o]: one tap's output channels are
    # contiguous, so the kernel reads them as float4s.
    params = torch.cat([t.float().reshape(-1) for t in (
        k00.permute(1, 2, 3, 0), *fold00, k01.permute(1, 2, 3, 0), *fold01,
        kd.permute(1, 2, 3, 0), *foldd)]).contiguous()
    N, _, H, W = imgs.shape
    conv01 = torch.empty((N, 8, H, W), dtype=torch.float32, device=imgs.device)
    down0 = torch.empty((N, 16, (H + 1) // 2, (W + 1) // 2), dtype=torch.float32,
                        device=imgs.device)
    lib = cuda_build.library("encoder_head")
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.encoder_head_f32(imgs.data_ptr(), params.data_ptr(), conv01.data_ptr(),
                                  down0.data_ptr(), N, H, W, stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return conv01, down0
