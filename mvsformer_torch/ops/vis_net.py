"""K2: the visibility CNN (entropy map -> per-pixel view weight).

Port of `mvsformer_tpu/ops/pallas/vis_net.py` `fused_visibility`. The kernel
is `csrc/vis_net.cu`; `visibility_net_plain` is its plain version: the flax
`VisibilityNet` eval path, three [3x3 conv, folded BN, ReLU] layers
1 -> 16 -> 16 -> 8, a 1x1 conv 8 -> 1 with bias and a sigmoid.
`visibility_net` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors. The kernel runs layers 1 and 2 on the tensor
cores in 3xTF32. Before it, the wrapper launches the source's pack kernel,
which splits their weights to TF32 hi and lo parts in mma B-fragment order
(the layout of `ops/tf32.pack_conv3x3`) on the device, in one launch.

Weights are torch layout: k0 [16,1,3,3], k1 [16,16,3,3], k2 [8,16,3,3],
k3 [1,8,1,1], b3 [1]; `folds` holds each layer's folded BN (mul, add) [C].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvsformer_torch.ops import cuda_build

_SHAPES = {"k0": (16, 1, 3, 3), "k1": (16, 16, 3, 3), "k2": (8, 16, 3, 3),
           "k3": (1, 8, 1, 1), "b3": (1,)}
# Floats of the packed weights: 233 parameters padded to 236, then the B
# fragments of layers 1 and 2, 4 x 32 lanes x 9 taps x 2 chunks x (2 + 1).
PACKED_FLOATS = 236 + 4 * 32 * 9 * 2 * 3


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
    cuda_build.check_f32_contiguous(what, ent=ent, k0=k0, k1=k1, k2=k2, k3=k3, b3=b3,
                                    **{f"fold {i}": t for i, t in enumerate(flat_folds)})
    lib = cuda_build.library("vis_net")
    with torch.cuda.device(ent.device):
        stream = torch.cuda.current_stream(ent.device).cuda_stream
        out = launch(lib, ent, pack(lib, k0, k1, k2, k3, b3, folds, stream), stream)
    cuda_build.LAUNCHES[what] += 1
    return cuda_build.eval_outputs(what, out, ent, k0, k1, k2, k3, b3, *flat_folds)


def pack(lib, k0, k1, k2, k3, b3, folds, stream):
    """The weights as the kernel reads them ([PACKED_FLOATS], written by
    `visibility_net_pack_f32` from `lib` on `stream`): layer 0's weights as
    [tap][channel], the folded BNs and the head, then k1's and k2's TF32
    parts in B-fragment order."""
    (m0, a0), (m1, a1), (m2, a2) = folds
    packed = torch.empty(PACKED_FLOATS, dtype=torch.float32, device=k1.device)
    rc = lib.visibility_net_pack_f32(*(t.data_ptr() for t in (k0, m0, a0, k1, m1, a1, k2, m2,
                                                               a2, k3, b3, packed)), stream)
    cuda_build.check_launch(rc, "visibility_net (pack)")
    return packed


def launch(lib, ent, packed, stream):
    """One launch of `visibility_net_f32` from `lib` on `stream`; raises if
    it was refused."""
    N, H, W = ent.shape
    out = torch.empty_like(ent)
    rc = lib.visibility_net_f32(ent.data_ptr(), packed.data_ptr(), out.data_ptr(), N, H, W,
                                stream)
    cuda_build.check_launch(rc, "visibility_net")
    return out
