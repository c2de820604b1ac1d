"""The 3xTF32 arithmetic and fragment plumbing of K6 `gsa_attention` (CPU).

The kernel (`csrc/gsa_attention.cu`) runs S = Q K^T and O = P V on
`mma.sync.m16n8k8` TF32 and hands S's accumulator fragment to the second
product as P's A fragment, with the keys of each 8-key chunk ordered so
that A columns t and t + 4 are keys 2t and 2t + 1. It cannot run here.
These tests hold that ordering to the PTX fragment layouts, one warp's
fragments end to end, and an emulation of the kernel's arithmetic (Q split
to nearest, K, V and P split by truncation, each chunk summed from zero,
the online softmax over the kernel's key tiles with exp2 and the folded
scale, keys past Nk masked) to attention in float64: within 1e-6 of the
output's scale where one TF32 product is a thousand times worse.
"""

import math
import re

import numpy as np
import pytest
import torch

from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.gsa_attention import HEAD_DIM, gsa_attention_plain
from mvsformer_torch.ops.tf32 import split_tf32, split_tf32_trunc

torch.set_num_threads(2)

SOURCE = (cuda_build.CSRC / "gsa_attention.cu").read_text()
KT = int(re.search(r"constexpr int KT = (\d+);", SOURCE).group(1))  # keys a tile


# The PTX ISA's m16n8k8 .tf32 fragments: lane 4g + t holds A (16 x 8) at
# (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) at (t, g),
# (t + 4, g); C and D (16 x 8) at (g, 2t), (g, 2t + 1), (g + 8, 2t),
# (g + 8, 2t + 1), as (row, column).
def a_pos(lane, i):
    g, t = divmod(lane, 4)
    return (g + 8 * (i & 1), t + 4 * (i >> 1))


def b_pos(lane, i):
    g, t = divmod(lane, 4)
    return (t + 4 * i, g)


def d_pos(lane, i):
    g, t = divmod(lane, 4)
    return (g + 8 * (i >> 1), 2 * t + (i & 1))


def order(col):
    """The kernel's order of a chunk's 8 reduction indices (head dims of S,
    keys of O): A column (B row) t is index 2t, t + 4 is 2t + 1."""
    return 2 * col if col < 4 else 2 * (col - 4) + 1


P_FROM_D = (0, 2, 1, 3)  # P's A fragment element i is the S accumulator P_FROM_D[i]


def test_s_accumulators_are_p_a_fragments_under_the_key_order():
    """Element i of a lane's P fragment is (row, key) = its S accumulator
    P_FROM_D[i], once A's columns are keys in the kernel's order; V's B
    fragment is V(key 2t, dim g) and V(key 2t + 1, dim g), the reads of
    csrc/gsa_attention.cu; K's is K(key g, dims 2t and 2t + 1) and Q's A
    fragment Q(g, 2t), Q(g + 8, 2t), Q(g, 2t + 1), Q(g + 8, 2t + 1), the
    order tf32_mma.cuh's split_a builds from two float2 loads."""
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i in range(4):
            row, col = a_pos(lane, i)
            assert (row, order(col)) == d_pos(lane, P_FROM_D[i])
        assert [(order(r), c) for r, c in (b_pos(lane, 0), b_pos(lane, 1))] == \
            [(2 * t, g), (2 * t + 1, g)]  # V: (key, dim); K: (dim, key) = (2t, g), (2t + 1, g)
        assert [(r, order(c)) for r, c in (a_pos(lane, i) for i in range(4))] == \
            [(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t + 1)]
    assert "const float a[4] = {d[0], d[2], d[1], d[3]};" in SOURCE


def mma(a_frag, b_frag, d_frag):
    """One warp's mma.m16n8k8: fragments [32, 4], [32, 2], [32, 4] in, D's
    fragments out, through the matrices the PTX layouts define."""
    A, Bm, D = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for lane in range(32):
        for i in range(4):
            A[a_pos(lane, i)] = a_frag[lane][i]
            D[d_pos(lane, i)] = d_frag[lane][i]
        for i in range(2):
            Bm[b_pos(lane, i)] = b_frag[lane][i]
    D = D + A @ Bm
    return [[D[d_pos(lane, i)] for i in range(4)] for lane in range(32)]


def test_one_warp_attends_through_its_fragments():
    """16 rows, 8 keys, 32 head dims through the fragments the kernel
    loads: S over four 8-dim chunks, P = f(S) on the accumulators, P's A
    fragment taken from them with no relayout, O over four 8-dim n-tiles;
    equal to f(Q K^T) V."""
    rng = np.random.default_rng(0)
    Q, K, V = rng.standard_normal((16, 32)), rng.standard_normal((8, 32)), rng.standard_normal((8, 32))
    s = [[0.0] * 4 for _ in range(32)]
    for ch in range(4):
        qa = [[Q[g + 8 * (i & 1), 8 * ch + 2 * t + (i >> 1)] for i in range(4)]
              for g, t in (divmod(lane, 4) for lane in range(32))]  # split_a(x0, x1)
        kb = [[K[g, 8 * ch + 2 * t + i] for i in range(2)]
              for g, t in (divmod(lane, 4) for lane in range(32))]  # float2 at (key g, dim 2t)
        s = mma(qa, kb, s)
    f = lambda x: math.exp(0.3 * x)
    p = [[f(x) for x in lane_s] for lane_s in s]
    pa = [[p[lane][P_FROM_D[i]] for i in range(4)] for lane in range(32)]
    out = np.zeros((16, 32))
    for nt in range(4):
        vb = [[V[2 * t + i, 8 * nt + g] for i in range(2)]
              for g, t in (divmod(lane, 4) for lane in range(32))]
        o = mma(pa, vb, [[0.0] * 4 for _ in range(32)])
        for lane in range(32):
            for i in range(4):
                r, c = d_pos(lane, i)
                out[r, 8 * nt + c] = o[lane][i]
    np.testing.assert_allclose(out, np.exp(0.3 * (Q @ K.T)) @ V, rtol=1e-12, atol=1e-12)


def rz32(x):
    """float64 -> float32 rounded toward zero, as the tensor cores round an
    mma's sum."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def mma_chain(ah, al, bh, bl, products):
    """A 3xTF32 step from zero, as tf32_mma.cuh's mma_3xtf32 issues it:
    lo*hi, then hi*lo, then hi*hi, each mma's sum exact (float64) and
    rounded toward zero to fp32; products=1: hi*hi alone."""
    d = lambda a, b: a.double() @ b.double()
    if products == 1:
        return rz32(d(ah, bh))
    x = rz32(d(al, bh))
    x = rz32(x.double() + d(ah, bl))
    return rz32(x.double() + d(ah, bh))


def emulate(q, k, v, nh, products=3):
    """The kernel's arithmetic per head: Q split to nearest (split_tf32),
    K, V and P by truncation (split_tf32_trunc); S summed over 4 chunks of
    8 dims and O over chunks of 8 keys, each chunk from zero and added in
    fp32 round-to-nearest; the online softmax per tile of KT keys in fp32
    with c = hd^-0.5 log2(e) rounded as the host rounds it, p =
    exp2(fma(S, c, -m)) (float64 product, one rounding); keys past Nk -inf."""
    B, N, C = q.shape
    Nk = k.shape[1]
    c = float(np.float32(np.float64(np.float32(HEAD_DIM ** -0.5)) * 1.4426950408889634))
    out = torch.empty(B, N, C)
    for h in range(nh):
        cols = slice(h * HEAD_DIM, (h + 1) * HEAD_DIM)
        qh, ql = split_tf32(q[..., cols].contiguous())
        m = torch.full((B, N, 1), -math.inf)
        l = torch.zeros(B, N, 1)
        o = torch.zeros(B, N, HEAD_DIM)
        for k0 in range(0, Nk, KT):
            n = min(KT, Nk - k0)
            kt, vt = torch.zeros(B, KT, HEAD_DIM), torch.zeros(B, KT, HEAD_DIM)
            kt[:, :n], vt[:, :n] = k[:, k0:k0 + n, cols], v[:, k0:k0 + n, cols]
            kh, kl = split_tf32_trunc(kt)
            s = torch.zeros(B, N, KT)
            for ch in range(4):
                d = slice(8 * ch, 8 * ch + 8)
                s = s + mma_chain(qh[..., d], ql[..., d], kh[..., d].transpose(1, 2),
                                  kl[..., d].transpose(1, 2), products)
            s[..., n:] = -math.inf
            mnew = torch.maximum(m, s.max(-1, keepdim=True).values * np.float32(c))
            corr = torch.exp2(m - mnew)
            p = torch.exp2((s.double() * c - mnew.double()).float())
            l, o, m = l * corr + p.sum(-1, keepdim=True), o * corr, mnew
            ph, pl = split_tf32_trunc(p)
            for j in range(KT // 8):
                keys = slice(8 * j, 8 * j + 8)
                vh, vl = split_tf32_trunc(vt[:, keys].contiguous())
                o = o + mma_chain(ph[..., keys], pl[..., keys], vh, vl, products)
        out[..., cols] = o / l
    return out


def attention64(q, k, v, nh):
    B, N, C = q.shape
    heads = lambda x: x.double().reshape(B, x.shape[1], nh, C // nh).transpose(1, 2)
    w = torch.softmax(heads(q) @ heads(k).transpose(-1, -2) * HEAD_DIM ** -0.5, dim=-1)
    return (w @ heads(v)).transpose(1, 2).reshape(B, N, C)


def inputs(seed, B, N, Nk, nh, logit_std=1.0):
    """q, k, v standard normal, q and k scaled so the logits' standard
    deviation is about logit_std."""
    rng = np.random.default_rng(seed)
    g = math.sqrt(logit_std)
    C = HEAD_DIM * nh
    return [torch.from_numpy((rng.standard_normal(s) * f).astype(np.float32)) for s, f in
            (((B, N, C), g), ((B, Nk, C), g), ((B, Nk, C), 1.0))]


def of_scale(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def test_the_kernel_tile_is_the_emulated_one():
    assert KT % 8 == 0 and f"constexpr int KT = {KT};" in SOURCE


# Nk: one key; one tile exactly; a tile and a part (masking); the DTU's 432.
@pytest.mark.parametrize("Nk", [1, 64, 100, 432])
def test_3xtf32_emulation_keeps_fp32_accuracy(Nk):
    q, k, v = inputs(Nk, 2, 48, Nk, 2)
    want = attention64(q, k, v, 2)
    err = of_scale(emulate(q, k, v, 2), want)
    assert err <= 1e-6, err
    assert of_scale(emulate(q, k, v, 2, products=1), want) > 1e-4  # V alone truncated to TF32


def test_3xtf32_emulation_over_logits_of_plus_minus_50():
    """Logits over about +-50 (their standard deviation 17), 200 keys: most
    rows' largest logit lies past the first tile, so the running max moves
    and O and the row sums are rescaled. fp32 logits that large carry
    rounding of a few 1e-6 of the output's scale in the plain fp32 version
    too, so the bound is the GPU test's 1e-5, and no worse than twice the
    plain version's own error."""
    q, k, v = inputs(7, 2, 48, 200, 2, logit_std=17.0)
    want = attention64(q, k, v, 2)
    logits = (q.double().reshape(2, 48, 2, 32).transpose(1, 2)
              @ k.double().reshape(2, 200, 2, 32).permute(0, 2, 3, 1)) * HEAD_DIM ** -0.5
    assert float(logits.max()) > 40 and float(logits.min()) < -40
    assert float((logits.argmax(-1) >= KT).double().mean()) > 0.5
    err = of_scale(emulate(q, k, v, 2), want)
    assert err <= 1e-5 and err <= 2 * of_scale(gsa_attention_plain(q, k, v, 2), want), err
    assert of_scale(emulate(q, k, v, 2, products=1), want) > 1e-3
