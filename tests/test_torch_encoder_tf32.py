"""The 3xTF32 numerics of K4 `encoder_head` and its weight packing (CPU).

The kernel (`csrc/encoder_head.cu`) runs its three convs on the tensor
cores as lo*hi + hi*lo + hi*hi over TF32 parts of both operands: the
weights split to nearest by its pack kernel, each activation split by
truncation where it is read, each chunk of products (a kernel column of
taps; conv00's 8 K values of every kernel row) summed from zero. It
cannot run here; these tests hold the plain packers the
device pack kernel is checked against (`ops/tf32.pack_conv_rows`,
`pack_conv`, `ops/encoder_head.pack_plain`) to the PTX m16n8k8 fragment
layout, and a PyTorch emulation of the kernel's arithmetic to the head in
float64, so the split is shown to keep fp32's accuracy where a single TF32
product does not.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mvsformer_torch.ops.encoder_head import PACKED_FLOATS, encoder_head_plain, pack_plain
from mvsformer_torch.ops.tf32 import (pack_b, pack_conv, pack_conv_rows, split_tf32,
                                      split_tf32_trunc)

torch.set_num_threads(2)


def wide(rng, shape):
    """Values of both signs with |x| spread from 1e-3 to 1e2."""
    return (rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-3, 2, shape)).astype(np.float32)


def unpack_b(packed):
    """[..., K/8, N/8, 32, 4] -> (hi, lo) [..., K, N], by the PTX definition
    of the m16n8k8 TF32 B fragment: lane 4g + t holds rows t and t + 4 of
    column g, here GEMM rows 2t and 2t + 1 of the chunk."""
    *lead, nk, nn, _, _ = packed.shape
    hi = np.zeros((*lead, 8 * nk, 8 * nn), np.float32)
    lo = np.zeros_like(hi)
    for chunk in range(nk):
        for f in range(nn):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                b0h, b1h, b0l, b1l = np.moveaxis(packed[..., chunk, f, lane, :], -1, 0)
                row, col = 8 * chunk + 2 * t, 8 * f + g
                hi[..., row, col], hi[..., row + 1, col] = b0h, b1h
                lo[..., row, col], lo[..., row + 1, col] = b0l, b1l
    return hi, lo


def assert_split_of(hi, lo, want):
    want_hi, want_lo = split_tf32(torch.from_numpy(np.ascontiguousarray(want)))
    np.testing.assert_array_equal(hi, want_hi.numpy())
    np.testing.assert_array_equal(lo, want_lo.numpy())


def test_pack_conv_rows_orders_k_by_tap_then_channel_and_pads_with_zeros():
    """conv00's fragments, [7 ky, 3 chunks, 1, 32, 4]: GEMM row j of kernel
    row ky is tap kx = j // 3, channel j % 3 (a pixel-major image row's 21
    values of one pixel), rows 21-23 zero."""
    rng = np.random.default_rng(0)
    k = wide(rng, (8, 3, 7, 7))
    packed = pack_conv_rows(torch.from_numpy(k)).numpy()
    assert packed.shape == (7, 3, 1, 32, 4)
    hi, lo = unpack_b(packed)  # [ky, 24, co]
    want = np.zeros((7, 24, 8), np.float32)
    for ky in range(7):
        for j in range(21):
            want[ky, j] = k[:, j % 3, ky, j // 3]
    assert_split_of(hi, lo, want)
    assert not hi[:, 21:].any() and not lo[:, 21:].any()


@pytest.mark.parametrize("co", [8, 16])
def test_pack_conv_follows_the_mma_b_fragment_layout_at_5x5(co):
    """conv01's (co = 8) and down0's (co = 16) fragments, [1 chunk, 25 taps,
    co/8, 32, 4]: GEMM row c of tap ky 5 + kx is input channel c."""
    rng = np.random.default_rng(co)
    k = wide(rng, (co, 8, 5, 5))
    packed = pack_conv(torch.from_numpy(k)).numpy()
    assert packed.shape == (1, 25, co // 8, 32, 4)
    hi, lo = unpack_b(packed[0][:, None])  # [tap, 8, co]
    assert_split_of(hi, lo, k.reshape(co, 8, 25).transpose(2, 1, 0))


def test_pack_b_rejects_a_ragged_gemm():
    with pytest.raises(ValueError):
        pack_b(torch.zeros(2, 20, 8))


def test_pack_plain_puts_the_folds_then_the_three_layers():
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    k00, k01, kd = t(wide(rng, (8, 3, 7, 7))), t(wide(rng, (8, 8, 5, 5))), t(wide(rng, (16, 8, 5, 5)))
    folds = [(t(rng.uniform(0.5, 1.5, c)), t(rng.standard_normal(c))) for c in (8, 8, 16)]
    packed = pack_plain(k00, folds[0], k01, folds[1], kd, folds[2])
    assert packed.shape == (PACKED_FLOATS,)
    assert torch.equal(packed[:64], torch.cat([v for f in folds for v in f]))
    w00, w01 = pack_conv_rows(k00).reshape(-1), pack_conv(k01).reshape(-1)
    assert torch.equal(packed[64:64 + w00.numel()], w00)
    assert torch.equal(packed[64 + w00.numel():64 + w00.numel() + w01.numel()], w01)
    assert torch.equal(packed[64 + w00.numel() + w01.numel():], pack_conv(kd).reshape(-1))


def test_split_tf32_trunc_truncates_and_keeps_the_value():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.concatenate([wide(rng, 4096), rng.standard_normal(4096).astype(
        np.float32), np.float32([0.0, -0.0, 1.0, -1.0, 1 + 2.0 ** -11, -(1 - 2.0 ** -12)])]))
    hi, lo = split_tf32_trunc(x)
    bits = lambda t: t.view(torch.int32)
    assert int((bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((bits(lo) & 0x1FFF).abs().max()) == 0
    # Truncation: |hi| <= |x| and hi keeps x's sign; the rest is lo's.
    assert bool((hi.abs() <= x.abs()).all()) and bool((hi * x >= 0).all())
    assert float(split_tf32_trunc(torch.tensor([1 + 2.0 ** -11]))[0]) == 1.0
    assert bool(((hi.double() + lo.double() - x.double()).abs()
                 <= 2.0 ** -20 * x.double().abs()).all())


def conv_chunks(x, k, stride, chunks, products):
    """A zero-padded KxK conv as the kernel sums it: each chunk of products
    (a 0/1 mask over k's (ci, ky, kx)) summed from zero, lo*hi + hi*lo +
    hi*hi (or with products=1 hi*hi alone), then added to the fp32 sum in
    order. x is split by truncation and k to nearest, as the kernel splits
    them."""
    (xh, xl), (kh, kl) = split_tf32_trunc(x.contiguous()), split_tf32(k.contiguous())
    conv = lambda a, b: F.conv2d(a, b, stride=stride, padding=(k.shape[-1] - 1) // 2)
    acc = 0.0
    for m in chunks:
        part = conv(xh, kh * m)
        if products == 3:
            part = conv(xl, kh * m) + conv(xh, kl * m) + part
        acc = acc + part
    return acc


def conv00_chunks():
    """conv00's chunks: GEMM rows 8q .. 8q + 7 of (kx, ci) = 3 kx + ci, over
    every kernel row."""
    j = 3 * torch.arange(7).view(1, 1, 7) + torch.arange(3).view(3, 1, 1)  # [ci, 1, kx]
    return [((j >= 8 * q) & (j < 8 * q + 8)).float().expand(3, 7, 7) for q in range(3)]


def column_chunks(ci, K=5):
    """conv01's and down0's chunks: one kernel column kx of taps, every ky
    and input channel."""
    return [(torch.arange(K) == kx).float().view(1, 1, K).expand(ci, K, K) for kx in range(K)]


def head_tf32(imgs, k00, fold00, k01, fold01, kd, foldd, products):
    def layer(x, k, fold, stride, chunks):
        mul, add = fold
        y = conv_chunks(x, k, stride, chunks, products)
        return F.leaky_relu(y * mul.view(1, -1, 1, 1) + add.view(1, -1, 1, 1), 0.1)

    conv01 = layer(layer(imgs, k00, fold00, 1, conv00_chunks()), k01, fold01, 1, column_chunks(8))
    return conv01, layer(conv01, kd, foldd, 2, column_chunks(8))


def test_the_chunks_cover_every_product_once():
    assert torch.equal(sum(conv00_chunks()), torch.ones(3, 7, 7))
    assert torch.equal(sum(column_chunks(8)), torch.ones(8, 5, 5))


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_3xtf32_emulation_is_fp32_accurate_and_1xtf32_is_not(kind):
    """Measured on the CPU (N=2, 3 x 21 x 30, the model's weight scales):
    3xTF32 within 4.6e-7 (normal images) and 4.3e-7 (|x| from 1e-3 to 1e2)
    of each output's scale against the head in float64 (the fp32 plain
    version 5.4e-7 and 7.1e-7), one TF32 product 1.4e-3 and 1.3e-3, about
    three thousand times more."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    N, H, W = 2, 21, 30
    imgs = t(rng.standard_normal((N, 3, H, W)) if kind == "normal" else wide(rng, (N, 3, H, W)))
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((8, 3, 7, 7), 147 ** -0.5), ((8, 8, 5, 5), 200 ** -0.5), ((16, 8, 5, 5), 200 ** -0.5))]
    folds = [(t(rng.uniform(0.5, 1.5, c)), t(0.1 * rng.standard_normal(c))) for c in (8, 8, 16)]
    weights = (ks[0], folds[0], ks[1], folds[1], ks[2], folds[2])
    want = encoder_head_plain(imgs.double(), *(
        (w[0].double(), w[1].double()) if isinstance(w, tuple) else w.double() for w in weights))
    errs = {}
    for products in (3, 1):
        got = head_tf32(imgs, *weights, products=products)
        assert [g.shape for g in got] == [w.shape for w in want]
        errs[products] = max(float((g.double() - w).abs().max()) / float(w.abs().max())
                             for g, w in zip(got, want))
    assert errs[3] <= 1e-5
    assert errs[1] >= 100 * errs[3]
