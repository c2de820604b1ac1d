"""K2: the visibility CNN (entropy map -> per-pixel view weight).

Port of `mvsformer_tpu/ops/pallas/vis_net.py` `fused_visibility`. The kernel
is `csrc/vis_net.cu`; `visibility_net_plain` is its plain version: the flax
`VisibilityNet` eval path, three [3x3 conv, folded BN, ReLU] layers
1 -> 16 -> 16 -> 8, a 1x1 conv 8 -> 1 with bias and a sigmoid.
`visibility_net` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors.

Weights are torch layout: k0 [16,1,3,3], k1 [16,16,3,3], k2 [8,16,3,3],
k3 [1,8,1,1], b3 [1]; `folds` holds each layer's folded BN (mul, add) [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.ops import cuda_build

_SHAPES = {"k0": (16, 1, 3, 3), "k1": (16, 16, 3, 3), "k2": (8, 16, 3, 3),
           "k3": (1, 8, 1, 1), "b3": (1,)}


def visibility_net_plain(ent, k0, k1, k2, k3, b3, folds):
    """ent [N, H, W] f32 -> weight [N, H, W] f32."""
    x = ent[:, None].float()
    for k, (mul, add) in zip((k0, k1, k2), folds):
        x = F.conv2d(x, k, padding=1)
        x = torch.relu(x * mul[None, :, None, None] + add[None, :, None, None])
    return torch.sigmoid(F.conv2d(x, k3, b3))[:, 0]


def visibility_net(ent, k0, k1, k2, k3, b3, folds):
    """The K2 wrapper; same arguments and result as the plain version."""
    what = "visibility_net"
    flat_folds = [t for pair in folds for t in pair]
    if not cuda_build.require_cuda_inputs(what, ent, k0, k1, k2, k3, b3, *flat_folds):
        return visibility_net_plain(ent, k0, k1, k2, k3, b3, folds)
    if ent.dim() != 3:
        raise ValueError(f"{what}: ent must be [N, H, W], got {tuple(ent.shape)}")
    for key, t in (("k0", k0), ("k1", k1), ("k2", k2), ("k3", k3), ("b3", b3)):
        if tuple(t.shape) != _SHAPES[key]:
            raise ValueError(f"{what}: {key} must be {_SHAPES[key]}, got {tuple(t.shape)}")
    for (mul, add), c in zip(folds, (16, 16, 8)):
        if tuple(mul.shape) != (c,) or tuple(add.shape) != (c,):
            raise ValueError(f"{what}: folded BN vectors must be [{c}]")
    cuda_build.check_f32_contiguous(what, ent=ent)
    (m0, a0), (m1, a1), (m2, a2) = folds
    params = torch.cat([t.reshape(-1).float() for t in
                        (k0, m0, a0, k1, m1, a1, k2, m2, a2, k3, b3)]).contiguous()
    N, H, W = ent.shape
    out = torch.empty_like(ent)
    lib = cuda_build.library("vis_net")
    with torch.cuda.device(ent.device):
        stream = torch.cuda.current_stream(ent.device).cuda_stream
        rc = lib.visibility_net_f32(ent.data_ptr(), params.data_ptr(), out.data_ptr(),
                                    N, H, W, stream)
    cuda_build.check_launch(rc, what)
    cuda_build.LAUNCHES[what] += 1
    return out
