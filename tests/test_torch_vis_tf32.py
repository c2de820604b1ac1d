"""The 3xTF32 numerics of K2 `visibility_net`, its weight packing, and the
kernel build's hash over the shared headers (CPU).

The kernel (`csrc/vis_net.cu`) runs layers 1 and 2 of the visibility CNN on
the tensor cores as lo*hi + hi*lo + hi*hi over TF32 parts of both operands.
It cannot run here; these tests hold `ops/tf32.pack_conv3x3` to the PTX
fragment layout at K2's two shapes, and a PyTorch emulation of K2 with
layers 1 and 2 summed from TF32 parts to `visibility_net_plain`, so the
split is shown to keep fp32's accuracy where a single TF32 product does not.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.fpn_level import pack_k3
from mvsformer_torch.ops.tf32 import pack_conv3x3, split_tf32
from mvsformer_torch.ops.vis_net import visibility_net_plain

torch.set_num_threads(2)


@pytest.mark.parametrize("ci,co", [(16, 16), (16, 8)])
def test_pack_conv3x3_follows_the_mma_b_fragment_layout(ci, co):
    """Unpack by the PTX definition of the m16n8k8 TF32 B fragment (lane
    4g + t holds rows t and t + 4 of column g), with rows t and t + 4 the
    input channels 2t and 2t + 1 of the chunk: hi + lo gives k back."""
    rng = np.random.default_rng(ci + co)
    k = torch.from_numpy((rng.standard_normal((co, ci, 3, 3)) * 10.0 ** rng.uniform(
        -3, 2, (co, ci, 3, 3))).astype(np.float32))
    packed = pack_conv3x3(k).numpy()
    assert packed.shape == (ci // 8, 9, co // 8, 32, 4)
    hi, lo = np.zeros((co, ci, 3, 3), np.float32), np.zeros((co, ci, 3, 3), np.float32)
    for chunk in range(ci // 8):
        for tap in range(9):
            for f in range(co // 8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    b0h, b1h, b0l, b1l = packed[chunk, tap, f, lane]
                    o, c, ky, kx = 8 * f + g, 8 * chunk + 2 * t, tap // 3, tap % 3
                    hi[o, c, ky, kx], lo[o, c, ky, kx] = b0h, b0l
                    hi[o, c + 1, ky, kx], lo[o, c + 1, ky, kx] = b1h, b1l
    want_hi, want_lo = split_tf32(k)
    np.testing.assert_array_equal(hi, want_hi.numpy())
    np.testing.assert_array_equal(lo, want_lo.numpy())


def test_pack_k3_is_pack_conv3x3_at_64_input_channels():
    k3 = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 64, 3, 3)).astype(
        np.float32))
    assert torch.equal(pack_k3(k3), pack_conv3x3(k3))
    with pytest.raises(ValueError):
        pack_conv3x3(k3[:, :12])


def vis_weights(rng):
    """K2's weights at the model's scale, as tests/test_torch_cuda.py draws them."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((16, 1, 3, 3), 9 ** -0.5), ((16, 16, 3, 3), 144 ** -0.5), ((8, 16, 3, 3), 144 ** -0.5))]
    folds = [(t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)))
             for c in (16, 16, 8)]
    return (*ks, t(rng.standard_normal((1, 8, 1, 1)) * 0.35), t(rng.standard_normal(1) * 0.1),
            folds)


def vis_tf32(ent, k0, k1, k2, k3, b3, folds, products):
    """visibility_net_plain with layers 1 and 2 summed from TF32 parts: 3xTF32
    (lo*hi + hi*lo + hi*hi) or, with products=1, a single TF32 product."""
    (m0, a0), *rest = folds
    x = torch.relu(F.conv2d(ent[:, None], k0, padding=1) * m0.view(1, -1, 1, 1)
                   + a0.view(1, -1, 1, 1))
    for k, (mul, add) in zip((k1, k2), rest):
        (xh, xl), (kh, kl) = split_tf32(x), split_tf32(k)
        y = F.conv2d(xh, kh, padding=1)
        if products == 3:
            y = F.conv2d(xl, kh, padding=1) + F.conv2d(xh, kl, padding=1) + y
        x = torch.relu(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1))
    return torch.sigmoid(F.conv2d(x, k3, b3))[:, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_emulation_is_fp32_accurate_and_1xtf32_is_not(seed):
    """Measured on the CPU (N=2, 24x32, ent in [0, 3.5], weights at the
    model's scale; outputs 0.20-0.83): 3xTF32 within 1.5e-7 / 1.8e-7 of the
    plain version at seeds 0 / 1, one TF32 product 1.71e-4 / 1.75e-4, about
    a thousand times more and 17 times K2's bound of 1e-5 on the card."""
    rng = np.random.default_rng(seed)
    weights = vis_weights(rng)
    ent = torch.from_numpy(rng.uniform(0, 3.5, (2, 24, 32)).astype(np.float32))
    want = visibility_net_plain(ent, *weights)
    err3 = float((vis_tf32(ent, *weights, products=3) - want).abs().max())
    err1 = float((vis_tf32(ent, *weights, products=1) - want).abs().max())
    assert err3 <= 1e-6
    assert err1 >= 10 * err3


def test_lib_path_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh gives every kernel a new library path, so a
    header edit never loads a stale build (on a copy of csrc)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["tf32_mma.cuh", "warp_taps.cuh"]
    before = {name: cuda_build.lib_path(name) for name in cuda_build.SIGNATURES}
    assert {name: cuda_build.lib_path(name) for name in cuda_build.SIGNATURES} == before
    for header in headers:
        header.write_bytes(header.read_bytes() + b"\n")
        after = {name: cuda_build.lib_path(name) for name in cuda_build.SIGNATURES}
        assert all(after[name] != before[name] for name in before)
        before = after
    (csrc / "vis_net.cu").write_bytes((csrc / "vis_net.cu").read_bytes() + b"\n")
    assert cuda_build.lib_path("vis_net") != after["vis_net"]
    assert cuda_build.lib_path("fpn_level") == after["fpn_level"]
