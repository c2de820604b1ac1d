"""The 3xTF32 numerics of K5 `fpn_level` and its weight packing (CPU).

The kernel (`csrc/fpn_level.cu`) runs the 3x3 conv on the tensor cores as
lo*hi + hi*lo + hi*hi over TF32 parts of both operands. It cannot run here;
these tests hold the plain helpers the wrapper uses (`tf32_round`,
`split_tf32`, `pack_k3`) to the PTX fragment layout, and a PyTorch
emulation of the 3xTF32 conv to the plain fp32 level, so the split is shown
to keep fp32's accuracy where a single TF32 product does not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsformer_torch.models.blocks import swish
from mvsformer_torch.ops.fpn_level import (LEVELS, fpn_level_plain, pack_k3, split_tf32,
                                           tf32_round)
from mvsformer_torch.ops.resize import resize_bilinear

torch.set_num_threads(2)


def wide(rng, shape):
    """Values of both signs with |x| spread from 1e-3 to 1e2."""
    return (rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, 2, shape)).astype(np.float32)


def test_tf32_round_clears_the_low_bits_and_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([wide(rng, 4096), rng.standard_normal(4096).astype(
        np.float32), np.float32([0.0, -0.0, 1.0, -1.0, 1 + 2.0 ** -11, 1 - 2.0 ** -12])]))
    hi, lo = split_tf32(x)
    bits = lambda t: t.view(torch.int32)
    assert int((bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((bits(lo) & 0x1FFF).abs().max()) == 0
    # Round to nearest: hi is within half a TF32 ulp (2^-11 of |x|) of x.
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    # A tie rounds away from zero, as cvt.rna does.
    assert float(tf32_round(torch.tensor([1 + 2.0 ** -11]))) == 1 + 2.0 ** -10
    assert float(tf32_round(torch.tensor([-(1 + 2.0 ** -11)]))) == -(1 + 2.0 ** -10)
    # hi + lo is x within 2^-22 of |x|.
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -22 * x.double().abs()).all())


@pytest.mark.parametrize("co", [8, 16, 32])
def test_pack_k3_follows_the_mma_b_fragment_layout(co):
    """Unpack by the PTX definition of the m16n8k8 TF32 B fragment (lane
    4g + t holds rows t and t + 4 of column g), with rows t and t + 4 the
    input channels 2t and 2t + 1 of the chunk: hi + lo gives k3 back."""
    rng = np.random.default_rng(co)
    k3 = torch.from_numpy(wide(rng, (co, 64, 3, 3)))
    packed = pack_k3(k3).numpy()
    assert packed.shape == (8, 9, co // 8, 32, 4)
    hi, lo = np.zeros((co, 64, 3, 3), np.float32), np.zeros((co, 64, 3, 3), np.float32)
    for chunk in range(8):
        for tap in range(9):
            for f in range(co // 8):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    b0h, b1h, b0l, b1l = packed[chunk, tap, f, lane]
                    o, ky, kx = 8 * f + g, tap // 3, tap % 3
                    hi[o, 8 * chunk + 2 * t, ky, kx], lo[o, 8 * chunk + 2 * t, ky, kx] = b0h, b0l
                    hi[o, 8 * chunk + 2 * t + 1, ky, kx] = b1h
                    lo[o, 8 * chunk + 2 * t + 1, ky, kx] = b1l
    want_hi, want_lo = split_tf32(k3)
    np.testing.assert_array_equal(hi, want_hi.numpy())
    np.testing.assert_array_equal(lo, want_lo.numpy())
    err = np.abs(hi.astype(np.float64) + lo - k3.numpy())
    assert (err <= 2.0 ** -22 * np.abs(k3.numpy())).all()


def level_tf32(prev, lat, w1, b1, k3, b3, fold, products):
    """fpn_level_plain with its 3x3 conv summed from TF32 parts: 3xTF32
    (lo*hi + hi*lo + hi*hi) or, with products=1, a single TF32 product."""
    mul, add = fold
    h, w = prev.shape[-2:]
    intra = resize_bilinear(prev, (2 * h, 2 * w), align_corners=True) + F.conv2d(lat, w1, b1)
    (xh, xl), (kh, kl) = split_tf32(intra), split_tf32(k3)
    y = F.conv2d(xh, kh, padding=1)
    if products == 3:
        y = F.conv2d(xl, kh, padding=1) + F.conv2d(xh, kl, padding=1) + y
    return swish((y + b3.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1))


@pytest.mark.parametrize("cl,co", LEVELS)
def test_3xtf32_emulation_is_fp32_accurate_and_1xtf32_is_not(cl, co):
    """Measured on the CPU (this seed, N=2, 12x16 -> 24x32, output scale
    about 6): 3xTF32 within 3.6e-7 / 4.4e-7 / 4.7e-7 of the output's scale
    at (cl, co) = (32,32) / (16,16) / (8,8), one TF32 product 3.0e-4 /
    2.7e-4 / 2.6e-4, about 600 times more."""
    rng = np.random.default_rng(cl)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    N, h, w = 2, 12, 16
    prev, lat = t(rng.standard_normal((N, 64, h, w))), t(rng.standard_normal((N, cl, 2 * h, 2 * w)))
    weights = (t(rng.standard_normal((64, cl, 1, 1)) * cl ** -0.5), t(rng.standard_normal(64) * 0.1),
               t(rng.standard_normal((co, 64, 3, 3)) * 576 ** -0.5), t(rng.standard_normal(co) * 0.1),
               (t(rng.uniform(0.5, 1.5, co)), t(0.1 * rng.standard_normal(co))))
    want = fpn_level_plain(prev, lat, *weights)
    scale = float(want.abs().max())
    err3 = float((level_tf32(prev, lat, *weights, products=3) - want).abs().max()) / scale
    err1 = float((level_tf32(prev, lat, *weights, products=1) - want).abs().max()) / scale
    assert err3 <= 1e-5
    assert err1 >= 10 * err3

