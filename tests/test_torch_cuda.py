"""The port's hand-written kernels against their plain versions, on the GPU.

Every test here needs an NVIDIA GPU with the CUDA toolkit, and skips
without one. This file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mvsformer_torch.models.blocks import swish
from mvsformer_torch.models.fpn import FPNDecoder, FPNEncoder
from mvsformer_torch.models.stagenet import StageNet, VisibilityNet
from mvsformer_torch.models.twins import GlobalSubsampledAttention
from mvsformer_torch.ops import cuda_build, geometry
from mvsformer_torch.ops.encoder_head import PACKED_FLOATS as ENCODER_HEAD_PACKED_FLOATS
from mvsformer_torch.ops.encoder_head import encoder_head, encoder_head_plain
from mvsformer_torch.ops.encoder_head import pack as encoder_head_pack
from mvsformer_torch.ops.encoder_head import pack_plain as encoder_head_pack_plain
from mvsformer_torch.ops.fpn_level import LEVELS, fpn_level, fpn_level_plain
from mvsformer_torch.ops.gsa_attention import gsa_attention, gsa_attention_plain
from mvsformer_torch.ops.stage_tail import depth_decode, depth_decode_plain
from mvsformer_torch.ops.tf32 import pack_conv3x3
from mvsformer_torch.ops.vis_net import PACKED_FLOATS, pack, visibility_net, visibility_net_plain
from mvsformer_torch.ops.warp_corr import (warp_corr_fwd, warp_corr_fwd_plain, warp_group_corr,
                                           warp_group_corr_plain)
from mvsformer_torch.ops.warp_corr_train import (WarpCorrTrain, warp_corr_bwd,
                                                 warp_corr_bwd_plain)
from mvsformer_torch.utils.cams import read_cam_file, write_cam_file
from mvsformer_torch.utils.image import read_image, write_png
from mvsformer_torch.utils.pfm import save_pfm

torch.set_num_threads(2)  # xdist workers share the cores

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def cams(rng, B, V, H, W, kind="default"):
    """Composed projections (src [B, V, 4, 4], ref [B, 4, 4]). "default":
    one reference camera, sources up to 4 units aside and turned by up to
    0.05 rad; "per_sample": every sample has its own reference camera as
    well; "rotated": sources turned by 0.3-0.5 rad about the optical axis
    (and 0.05-0.1 about y) at 2.5 times the focal length, so neighbouring
    pixels' taps lie 2.2-2.5 pixels apart along x and 0.7 across rows, and
    about 85% of them fall outside the image; "zoomed": sources at 3 times
    the focal length, so neighbouring pixels' taps lie 3 pixels apart and
    only the middle third of the reference view lands in the source."""
    def full(tx, ang, roll=0.0, ty=0.0, zoom=1.0):
        K = np.array([[1.2 * W * zoom, 0, W / 2], [0, 1.2 * W * zoom, H / 2], [0, 0, 1]],
                     np.float32)
        c, s = np.cos(ang), np.sin(ang)
        cr, sr = np.cos(roll), np.sin(roll)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]]) @ np.array(
            [[c, 0, s], [0, 1, 0], [-s, 0, c]])
        P[0, 3], P[1, 3] = tx, ty
        out = np.eye(4, dtype=np.float32)
        out[:3] = K @ P[:3]
        return out

    if kind == "per_sample":
        ref = np.stack([full(rng.uniform(-2, 2), rng.uniform(-0.1, 0.1), 0.0,
                             rng.uniform(-2, 2)) for _ in range(B)])
    else:
        ref = np.stack([full(0.0, 0.0)] * B)
    if kind == "rotated":
        src = np.stack([np.stack([full(rng.uniform(-4, 4), rng.uniform(0.05, 0.1),
                                       rng.uniform(0.3, 0.5), zoom=2.5) for _ in range(V)])
                        for _ in range(B)])
    elif kind == "zoomed":
        src = np.stack([np.stack([full(rng.uniform(-4, 4), rng.uniform(-0.05, 0.05), zoom=3.0)
                                  for _ in range(V)]) for _ in range(B)])
    else:
        src = np.stack([np.stack([full(rng.uniform(-4, 4), rng.uniform(-0.05, 0.05))
                                  for _ in range(V)]) for _ in range(B)])
    return src, ref


def depth_hypotheses(rng, B, D, H, W, kind="default"):
    """[B, D, H, W] sorted per pixel, in 425-900, or ("per_sample") in
    425-900 for even samples and 500-1000 for odd ones."""
    return np.stack([np.sort(rng.uniform(*((500, 1000) if kind == "per_sample" and b % 2
                                           else (425, 900)), (D, H, W)).astype(np.float32),
                             axis=0) for b in range(B)])


# The first three: the earliest shapes. Then every C at its DTU stage's D
# (64/32, 32/16, 16/8, 8/4) with H*W not a multiple of the kernel's pixel
# tile (16, 32, 64, 128 pixels); B = 2 with its own cameras and depth range
# per sample; a strongly rotated source.
K1_CASES = [(1, 4, 36, 48, 64, 32, "default"), (2, 1, 37, 45, 8, 4, "default"),
            (1, 2, 72, 96, 16, 8, "default"),
            (1, 4, 37, 45, 64, 32, "default"), (1, 4, 39, 50, 32, 16, "default"),
            (1, 4, 41, 57, 16, 8, "default"), (1, 4, 43, 61, 8, 4, "default"),
            (2, 3, 37, 45, 64, 32, "per_sample"), (2, 3, 43, 61, 8, 4, "per_sample"),
            (1, 2, 39, 50, 32, 16, "rotated"), (1, 2, 43, 61, 8, 4, "rotated")]


@pytest.mark.parametrize("B,V,H,W,C,D,kind", K1_CASES)
def test_warp_group_corr_matches_plain(dev, B, V, H, W, C, D, kind):
    rng = np.random.default_rng(0)
    src_p, ref_p = cams(rng, B, V, H, W, kind)
    dv = depth_hypotheses(rng, B, D, H, W, kind)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((B, H, W, C)).astype(np.float32),
        rng.standard_normal((B, V, H, W, C)).astype(np.float32), src_p, ref_p, dv)]
    before = cuda_build.LAUNCHES["warp_group_corr"]
    corr, ent = warp_group_corr(*args, groups=8)
    assert cuda_build.LAUNCHES["warp_group_corr"] == before + 1
    want_corr, want_ent = warp_group_corr_plain(*args, groups=8)
    # Same products summed in another order; coordinates differ in the last bit.
    torch.testing.assert_close(corr, want_corr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ent, want_ent, rtol=1e-4, atol=1e-4)
    if kind == "rotated":  # many taps fall outside the source image
        invalid = geometry.plane_sweep_coords(args[2][:, 0], args[3], args[4], H, W)[2]
        assert 0.5 < invalid.float().mean() < 0.95


def test_warp_corr_blocks_share_an_sm(dev):
    """K1 and K7 keep several 256-thread blocks on an SM at every DTU stage."""
    lib = cuda_build.library("warp_corr")
    for c, d in ((64, 32), (32, 16), (16, 8), (8, 4)):
        for entropy in (1, 0):
            assert lib.warp_corr_blocks_per_sm(c, d, entropy) >= 4
    assert lib.warp_corr_blocks_per_sm(12, 4, 1) == 0


def vis_inputs(rng, dev, N, H, W):
    """K2's weights at the model's scale, then ent in [0, 3.5]."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((16, 1, 3, 3), 9 ** -0.5), ((16, 16, 3, 3), 144 ** -0.5), ((8, 16, 3, 3), 144 ** -0.5))]
    folds = [(t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c)))
             for c in (16, 16, 8)]
    k3, b3 = t(rng.standard_normal((1, 8, 1, 1)) * 0.35), t(rng.standard_normal(1) * 0.1)
    return t(rng.uniform(0, 3.5, (N, H, W))), (*ks, k3, b3, folds)


# Tiles (16 x 16 outputs) cut by the image edge: 3 x 17 x 50.
@pytest.mark.parametrize("N,H,W", [(4, 144, 192), (3, 17, 50)])
def test_visibility_net_matches_plain(dev, N, H, W):
    ent, weights = vis_inputs(np.random.default_rng(1), dev, N, H, W)
    before = cuda_build.LAUNCHES["visibility_net"]
    got = visibility_net(ent, *weights)
    assert cuda_build.LAUNCHES["visibility_net"] == before + 1
    want = visibility_net_plain(ent, *weights)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)  # fp32, sum order


@pytest.mark.parametrize("N,H,W", [(2, 144, 192), (3, 17, 50)])
def test_visibility_net_is_fp32_accurate(dev, N, H, W):
    """K2 (3xTF32 on the tensor cores) against visibility_net_plain's
    layers evaluated in float64: within 2e-6. The CPU emulation of 3xTF32
    reads 1.5e-7 to 1.8e-7 against the fp32 plain version, one TF32
    product 1.7e-4 (tests/test_torch_vis_tf32.py)."""
    ent, (k0, k1, k2, k3, b3, folds) = vis_inputs(np.random.default_rng(13), dev, N, H, W)
    got = visibility_net(ent, k0, k1, k2, k3, b3, folds)
    x = ent[:, None].double()
    for k, (mul, add) in zip((k0, k1, k2), folds):
        x = torch.nn.functional.conv2d(x, k.double(), padding=1)
        x = torch.relu(x * mul.double().view(1, -1, 1, 1) + add.double().view(1, -1, 1, 1))
    want = torch.sigmoid(torch.nn.functional.conv2d(x, k3.double(), b3.double()))[:, 0]
    assert float((got.double() - want).abs().max()) <= 2e-6


def test_visibility_net_packs_its_weights_as_pack_conv3x3(dev):
    """The device pack kernel writes layer 0's weights as [tap][channel],
    the folded BNs and the head, then k1's and k2's TF32 parts in the
    layout of ops/tf32.pack_conv3x3, bit for bit."""
    _, (k0, k1, k2, k3, b3, folds) = vis_inputs(np.random.default_rng(14), dev, 1, 8, 8)
    lib = cuda_build.library("vis_net")
    assert lib.visibility_net_packed_floats() == PACKED_FLOATS
    packed = pack(lib, k0, k1, k2, k3, b3, folds, torch.cuda.current_stream().cuda_stream)
    (m0, a0), (m1, a1), (m2, a2) = folds
    params = torch.cat([t.reshape(-1) for t in
                        (k0.reshape(16, 9).t(), m0, a0, m1, a1, m2, a2, k3, b3)])
    w1, w2 = pack_conv3x3(k1).reshape(-1), pack_conv3x3(k2).reshape(-1)
    assert torch.equal(packed[:233], params)
    assert torch.equal(packed[236:236 + w1.numel()], w1)
    assert torch.equal(packed[236 + w1.numel():], w2)


def test_visibility_net_raises_instead_of_falling_back(dev):
    ent, (k0, k1, k2, k3, b3, folds) = vis_inputs(np.random.default_rng(15), dev, 1, 8, 8)
    with pytest.raises(ValueError):  # a CPU weight among CUDA tensors
        visibility_net(ent, k0, k1.cpu(), k2, k3, b3, folds)
    with pytest.raises(ValueError):  # a weight the kernel cannot read as laid out
        visibility_net(ent, k0, k1.transpose(2, 3), k2, k3, b3, folds)
    with pytest.raises(TypeError):  # float64 is not taken
        visibility_net(ent.double(), k0, k1, k2, k3, b3, folds)


# The DTU request's 4 stages at their temperatures; B = 2 on both load
# paths; an odd H*W (the scalar path); D = 1, 3 and 48 (two passes, merged);
# logits x 30, whose largest terms dwarf the rest.
DECODE_CASES = [((1, 32, 144, 192), 5.0, 3.0), ((1, 16, 288, 384), 5.0, 3.0),
                ((1, 8, 576, 768), 5.0, 3.0), ((1, 4, 1152, 1536), 1.0, 3.0),
                ((2, 4, 37, 45), 5.0, 3.0), ((2, 8, 36, 48), 1.0, 3.0),
                ((1, 1, 37, 45), 5.0, 3.0), ((2, 3, 20, 44), 1.0, 3.0),
                ((1, 48, 37, 45), 5.0, 3.0), ((2, 48, 24, 32), 1.0, 3.0),
                ((1, 32, 144, 192), 5.0, 30.0), ((1, 48, 37, 45), 1.0, 30.0)]


@pytest.mark.parametrize("shape,tmp,scale", DECODE_CASES)
def test_depth_decode_matches_plain(dev, shape, tmp, scale):
    rng = np.random.default_rng(2)
    logits = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)
    dv = torch.from_numpy(np.sort(rng.uniform(425, 900, shape).astype(np.float32), 1)).to(dev)
    before = cuda_build.LAUNCHES["depth_decode"]
    depth, conf = depth_decode(logits, dv, tmp)
    assert cuda_build.LAUNCHES["depth_decode"] == before + 1
    want_d, want_c = depth_decode_plain(logits, dv, tmp)
    # exp(tmp*(l-m)) against softmax(tmp*l): ~1e-6 relative in each weight.
    torch.testing.assert_close(depth, want_d, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(conf, want_c, rtol=1e-5, atol=1e-6)


def stage_inputs(dev, rng, B, V, H, W, C, D):
    """StageNet's inputs: features, cameras as [.., 2, 4, 4] (the composed
    projection in slot 0 and identity intrinsics, which compose to it) and
    pixelwise depths."""
    src_p, ref_p = cams(rng, B, V, H, W)
    slots = lambda p: np.stack([p, np.broadcast_to(np.eye(4, dtype=np.float32), p.shape)], -3)
    t = tensor(dev)
    return (t(rng.standard_normal((B, C, H, W))), t(rng.standard_normal((B, V - 1, C, H, W))),
            t(slots(ref_p)), t(slots(src_p[:, 1:])),
            torch.from_numpy(depth_hypotheses(rng, B, D, H, W)).to(dev))


def eval_forward(kernel, dev):
    """A toy eval forward that goes through `kernel`, with weights (or, for
    K1, features) that require grad -> its outputs, as a tuple. K1 is called
    directly: in StageNet its outputs reach the loss only through K2's."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    t = tensor(dev)
    if kernel == "warp_group_corr":
        ref, *rest = warp_inputs(dev, rng, 1, 2, 16, 20, 8, 4)
        return warp_group_corr(ref.requires_grad_(), *rest)
    if kernel == "visibility_net":
        return (VisibilityNet().to(dev).eval()(t(rng.uniform(0, 3.5, (2, 16, 16)))),)
    if kernel == "depth_decode":
        out = StageNet(4).to(dev).eval()(*stage_inputs(dev, rng, 1, 3, 16, 32, 8, 4), 5.0)
        return out["depth"], out["photometric_confidence"]
    if kernel == "encoder_head":
        return FPNEncoder().to(dev).eval()(t(rng.standard_normal((1, 3, 32, 32))))
    if kernel == "fpn_level":
        return FPNDecoder().to(dev).eval()(*(t(rng.standard_normal(s)) for s in (
            (1, 8, 32, 32), (1, 16, 16, 16), (1, 32, 8, 8), (1, 64, 4, 4))))
    assert kernel == "gsa_attention"
    return (GlobalSubsampledAttention(64, 2, 2).to(dev).eval()(
        t(rng.standard_normal((1, 8, 8, 64)))),)


@pytest.mark.parametrize("kernel", ["warp_group_corr", "visibility_net", "depth_decode",
                                    "encoder_head", "fpn_level", "gsa_attention"])
def test_eval_kernel_backward_raises(dev, kernel):
    """A backward through an eval kernel raises, naming it (its outputs are
    written through ctypes, out of autograd's sight); under no_grad or
    inference_mode the same forward adds no autograd node, launches as often
    and gives the same outputs."""
    before = cuda_build.LAUNCHES[kernel]
    outs = eval_forward(kernel, dev)
    launches = cuda_build.LAUNCHES[kernel] - before
    assert launches > 0 and all(o.grad_fn is not None for o in outs)
    with pytest.raises(RuntimeError, match=f"{kernel}: this eval kernel has no backward"):
        sum(o.sum() for o in outs).backward()
    for quiet in (torch.no_grad, torch.inference_mode):
        before = cuda_build.LAUNCHES[kernel]
        with quiet():
            got = eval_forward(kernel, dev)
        assert cuda_build.LAUNCHES[kernel] - before == launches
        assert all(o.grad_fn is None and not o.requires_grad for o in got)
        for a, b in zip(outs, got):
            torch.testing.assert_close(a.detach(), b.clone())


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros((1, 8, 8, 8), device=dev)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA tensors
        warp_group_corr(x, x[:, None], torch.eye(4)[None, None], torch.eye(4, device=dev)[None],
                        torch.ones((1, 4, 8, 8), device=dev))
    with pytest.raises(TypeError):  # float64 is not taken
        depth_decode(torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.float64),
                     torch.zeros((1, 4, 8, 8), device=dev, dtype=torch.float64), 1.0)
    with pytest.raises(ValueError):  # D > 32
        eye = torch.eye(4, device=dev)
        warp_group_corr(x, x[:, None], eye[None, None], eye[None],
                        torch.ones((1, 33, 8, 8), device=dev))


def tensor(dev):
    return lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def head_weights(rng, t):
    ks = [t(rng.standard_normal(s) * f) for s, f in
          (((8, 3, 7, 7), 147 ** -0.5), ((8, 8, 5, 5), 200 ** -0.5), ((16, 8, 5, 5), 200 ** -0.5))]
    folds = [(t(rng.uniform(0.5, 1.5, c)), t(0.1 * rng.standard_normal(c))) for c in (8, 8, 16)]
    return ks[0], folds[0], ks[1], folds[1], ks[2], folds[2]


# H and W not multiples of the 16 x 32 tile, odd sizes (down0 of ceil(H/2)),
# the tile cut on every side at N = 5, exactly one tile, a 1-pixel-high image.
@pytest.mark.parametrize("N,H,W", [(2, 37, 45), (1, 64, 96), (1, 15, 70), (5, 33, 65),
                                   (1, 16, 32), (3, 1, 3)])
def test_encoder_head_matches_plain(dev, N, H, W):
    rng = np.random.default_rng(3)
    t = tensor(dev)
    imgs = t(rng.standard_normal((N, 3, H, W)))
    weights = head_weights(rng, t)
    before = cuda_build.LAUNCHES["encoder_head"]
    got = encoder_head(imgs, *weights)
    assert cuda_build.LAUNCHES["encoder_head"] == before + 1
    want = encoder_head_plain(imgs, *weights)
    assert got[1].shape == (N, 16, (H + 1) // 2, (W + 1) // 2)
    for g, w in zip(got, want):  # fp32; 147-200 products per output summed in another order
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("N,H,W", [(5, 33, 65), (2, 17, 40)])
def test_encoder_head_is_fp32_accurate_over_a_wide_range(dev, N, H, W):
    """Images with |x| from 1e-3 to 1e2, against the head in float64: within
    1e-5 of each output's scale, ten times under K4's bound. The CPU
    emulation of the kernel's 3xTF32 reads about 3e-7 of scale and one TF32
    product about 5e-4 (tests/test_torch_encoder_tf32.py)."""
    rng = np.random.default_rng(16)
    t = tensor(dev)
    wide = rng.choice([-1.0, 1.0], (N, 3, H, W)) * 10.0 ** rng.uniform(-3, 2, (N, 3, H, W))
    imgs = t(wide)
    weights = head_weights(rng, t)
    got = encoder_head(imgs, *weights)
    want = encoder_head_plain(imgs.double(), *(
        tuple(v.double() for v in w) if isinstance(w, tuple) else w.double() for w in weights))
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_encoder_head_packs_its_weights_as_pack_plain(dev):
    """The device pack kernel writes the folded BNs and the three layers'
    TF32 parts in B-fragment order as ops/encoder_head.pack_plain (the
    layouts of ops/tf32.pack_conv_rows and pack_conv), bit for bit."""
    weights = head_weights(np.random.default_rng(17), tensor(dev))
    lib = cuda_build.library("encoder_head")
    assert lib.encoder_head_packed_floats() == ENCODER_HEAD_PACKED_FLOATS
    packed = encoder_head_pack(lib, *weights, torch.cuda.current_stream().cuda_stream)
    assert torch.equal(packed.cpu(), encoder_head_pack_plain(*(
        tuple(v.cpu() for v in w) if isinstance(w, tuple) else w.cpu() for w in weights)))


def test_encoder_head_keeps_two_blocks_per_sm(dev):
    """103,616 B of shared memory and at most 128 registers a thread
    (__launch_bounds__(256, 2)): two blocks share an SM, as the design note
    in csrc/encoder_head.cu says."""
    assert cuda_build.library("encoder_head").encoder_head_blocks_per_sm() == 2


def level_weights(rng, t, cl, co):
    return (t(rng.standard_normal((64, cl, 1, 1)) * cl ** -0.5), t(rng.standard_normal(64) * 0.1),
            t(rng.standard_normal((co, 64, 3, 3)) * 576 ** -0.5), t(rng.standard_normal(co) * 0.1),
            (t(rng.uniform(0.5, 1.5, co)), t(0.1 * rng.standard_normal(co))))


# Odd h and w, tiles (16 x 16 outputs, 16-pixel M fragments) cut by the
# image edge, a 1-pixel-high level, N = 3.
@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("N,h,w", [(2, 7, 9), (1, 12, 20), (1, 1, 3), (3, 1, 5), (3, 7, 9)])
@pytest.mark.parametrize("cl,co", LEVELS)
def test_fpn_level_matches_plain(dev, cl, co, N, h, w, emit):
    rng = np.random.default_rng(4)
    t = tensor(dev)
    prev, lat = t(rng.standard_normal((N, 64, h, w))), t(rng.standard_normal((N, cl, 2 * h, 2 * w)))
    weights = level_weights(rng, t, cl, co)
    before = cuda_build.LAUNCHES["fpn_level"]
    got = fpn_level(prev, lat, *weights, emit_intra=emit)
    assert cuda_build.LAUNCHES["fpn_level"] == before + 1
    want = fpn_level_plain(prev, lat, *weights, emit_intra=emit)
    # fp32 (3xTF32 on the tensor cores); the same align-corners weights,
    # 64 x 9 + cl products in another order.
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cl,co", LEVELS)
def test_fpn_level_is_fp32_accurate_over_a_wide_range(dev, cl, co):
    """Inputs with |x| from 1e-3 to 1e2, against the 3x3 conv, BN and swish
    in float64 on the plain version's fp32 intra' (so both interpolate with
    the same fp32 weights): within 1e-5 of the output's scale, ten times
    under K5's bound. The CPU emulation of 3xTF32 reads about 4e-7 of scale
    and one TF32 product about 3e-4 (tests/test_torch_fpn_tf32.py)."""
    rng = np.random.default_rng(12)
    t = tensor(dev)
    N, h, w = 3, 7, 9
    wide = lambda s: rng.choice([-1.0, 1.0], s) * 10.0 ** rng.uniform(-3, 2, s)
    prev, lat = t(wide((N, 64, h, w))), t(wide((N, cl, 2 * h, 2 * w)))
    weights = level_weights(rng, t, cl, co)
    out, intra = fpn_level(prev, lat, *weights, emit_intra=True)
    _, want_intra = fpn_level_plain(prev, lat, *weights, emit_intra=True)
    _, _, k3, b3, (mul, add) = weights
    y = torch.nn.functional.conv2d(want_intra.double(), k3.double(), b3.double(), padding=1)
    want = swish(y * mul.double().view(1, -1, 1, 1) + add.double().view(1, -1, 1, 1))
    for got, ref in ((out, want), (intra, want_intra)):
        scale = float(ref.abs().max())
        assert float((got.double() - ref.double()).abs().max()) <= 1e-5 * scale


# N not a multiple of the 64-row block; Nk above the 64-key tile and not a
# multiple of it, a single key, one tile exactly, or 7 keys; the four DTU
# head layouts (C = 64, 128, 256, 512) at Nk = 432; k and v as the halves of
# one tensor.
@pytest.mark.parametrize("B,N,Nk,nh", [(2, 300, 100, 2), (1, 1000, 432, 4), (3, 17, 1, 1),
                                       (1, 129, 64, 16), (2, 500, 432, 2), (1, 333, 432, 8),
                                       (1, 100, 432, 16), (2, 40, 7, 2)])
def test_gsa_attention_matches_plain(dev, B, N, Nk, nh):
    rng = np.random.default_rng(5)
    t = tensor(dev)
    C = 32 * nh
    q, kv = t(rng.standard_normal((B, N, C))), t(rng.standard_normal((B, Nk, 2 * C)))
    before = cuda_build.LAUNCHES["gsa_attention"]
    got = gsa_attention(q, kv[..., :C], kv[..., C:], nh)
    assert cuda_build.LAUNCHES["gsa_attention"] == before + 1
    want = gsa_attention_plain(q, kv[..., :C], kv[..., C:], nh)
    # fp32 logits and probabilities; sums in another order.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,Nk,nh", [(2, 300, 432, 2), (1, 100, 100, 16)])
def test_gsa_attention_is_fp32_accurate_over_a_wide_range(dev, B, N, Nk, nh):
    """Logits over about +-50 (q and k scaled so their standard deviation is
    17) against attention in float64: 3xTF32 products keep fp32's accuracy
    (tests/test_torch_gsa_tf32.py emulates them: ~1.5e-6 of scale there,
    one TF32 product ~3e-3)."""
    rng = np.random.default_rng(13)
    t = tensor(dev)
    C = 32 * nh
    g = 17.0 ** 0.5
    q = t(rng.standard_normal((B, N, C)) * g)
    kv = t(np.concatenate([rng.standard_normal((B, Nk, C)) * g,
                           rng.standard_normal((B, Nk, C))], axis=-1))
    k, v = kv[..., :C], kv[..., C:]
    got = gsa_attention(q, k, v, nh)
    heads = lambda x: x.double().reshape(B, x.shape[1], nh, 32).transpose(1, 2)
    logits = heads(q) @ heads(k).transpose(-1, -2) * 32 ** -0.5
    assert float(logits.max()) > 40 and float(logits.min()) < -40
    want = (torch.softmax(logits, -1) @ heads(v)).transpose(1, 2).reshape(B, N, C)
    assert float((got.double() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_gsa_attention_keeps_its_blocks_per_sm(dev):
    """The design's occupancy (csrc/gsa_attention.cu): four blocks of 4 warps
    an SM, at most 128 registers a thread and 38,912 bytes of shared
    memory a block."""
    assert cuda_build.library("gsa_attention").gsa_attention_blocks_per_sm() == 4


def test_new_wrappers_raise_instead_of_falling_back(dev):
    rng = np.random.default_rng(6)
    t = tensor(dev)
    imgs = t(rng.standard_normal((1, 3, 16, 16)))
    k00, f00, k01, f01, kd, fd = head_weights(rng, t)
    with pytest.raises(ValueError):  # a CPU weight among CUDA tensors
        encoder_head(imgs, k00.cpu(), f00, k01, f01, kd, fd)
    prev, lat = t(np.zeros((1, 64, 4, 4))), t(np.zeros((1, 8, 8, 8)))
    w8 = level_weights(rng, t, 8, 8)
    with pytest.raises(ValueError):  # a CPU input among CUDA tensors
        fpn_level(prev.cpu(), lat, *w8)
    with pytest.raises(ValueError):  # (cl, co) the kernel is not built for
        fpn_level(prev, lat, *level_weights(rng, t, 8, 16))
    q = t(np.zeros((1, 8, 64)))
    with pytest.raises(ValueError):  # a CPU key among CUDA tensors
        gsa_attention(q, q.cpu(), q, 2)
    with pytest.raises(ValueError):  # head width 16, not 32
        gsa_attention(q, q, q, 4)
    with pytest.raises(TypeError):  # float64 is not taken
        gsa_attention(q.double(), q.double(), q.double(), 2)


def warp_inputs(dev, rng, B, V, H, W, C, D, kind="default"):
    src_p, ref_p = cams(rng, B, V, H, W, kind)
    dv = depth_hypotheses(rng, B, D, H, W, kind)
    return [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((B, H, W, C)).astype(np.float32),
        rng.standard_normal((B, V, H, W, C)).astype(np.float32), src_p, ref_p, dv)]


# H, W not multiples of the 128-pixel block or of 8; V = 1; C = 8 and 64;
# D = 4 and 32, and 48 (K7 has no bound on D, K1 stops at 32).
WARP_SHAPES = [(1, 4, 36, 48, 64, 32), (2, 1, 37, 45, 8, 4), (1, 2, 19, 23, 16, 8),
               (1, 3, 17, 29, 64, 4), (1, 1, 13, 11, 32, 48)]
# K7 alone: every C at its stage's D with H*W not a multiple of the pixel
# tile, D = 48 (one and a half chunks at C = 64, twelve at C = 8), B = 2
# with its own cameras and depths per sample, a strongly rotated source.
K7_CASES = [(1, 4, 37, 45, 64, 32, "default"), (1, 4, 39, 50, 32, 16, "default"),
            (1, 4, 41, 57, 16, 8, "default"), (1, 4, 43, 61, 8, 4, "default"),
            (1, 2, 21, 19, 64, 48, "default"), (2, 2, 23, 29, 8, 48, "default"),
            (2, 3, 37, 45, 32, 16, "per_sample"), (1, 2, 41, 57, 16, 8, "rotated")]


@pytest.mark.parametrize("B,V,H,W,C,D,kind",
                         [(*shape, "default") for shape in WARP_SHAPES] + K7_CASES)
def test_warp_corr_fwd_matches_plain(dev, B, V, H, W, C, D, kind):
    rng = np.random.default_rng(7)
    args = warp_inputs(dev, rng, B, V, H, W, C, D, kind)
    before = cuda_build.LAUNCHES["warp_corr_fwd"]
    corr = warp_corr_fwd(*args, groups=8)
    assert cuda_build.LAUNCHES["warp_corr_fwd"] == before + 1
    want_corr = warp_corr_fwd_plain(*args, groups=8)
    # Same products summed in another order, on coordinates rounded as the
    # plain version rounds them.
    torch.testing.assert_close(corr, want_corr, rtol=1e-4, atol=1e-4)
    # Part of the warp falls outside the source frustum, where the taps are
    # zero-padded.
    _, _, src_p, ref_p, dv = args
    invalid = geometry.plane_sweep_coords(src_p[:, 0], ref_p, dv, H, W)[2]
    assert 0 < invalid.float().mean() < 1


# K8 alone: every C at its stage's D with H*W off the block's run of pixels
# (16, 32, 64, 128), B = 2 with its own cameras and depths per sample, D =
# 48 (one and a half depth chunks at C = 64, twelve at C = 8), and rotated
# and zoomed sources, whose neighbouring pixels' taps lie 2-3 source pixels
# apart, so each tap square holds for few depths.
K8_CASES = [(1, 4, 37, 45, 64, 32, "default"), (1, 4, 39, 50, 32, 16, "default"),
            (1, 4, 41, 57, 16, 8, "default"), (1, 4, 43, 61, 8, 4, "default"),
            (2, 3, 37, 45, 32, 16, "per_sample"), (2, 3, 43, 61, 8, 4, "per_sample"),
            (1, 2, 21, 19, 64, 48, "default"), (2, 2, 23, 29, 8, 48, "default"),
            (1, 2, 39, 50, 32, 16, "rotated"), (1, 2, 43, 61, 8, 4, "rotated"),
            (1, 2, 37, 45, 64, 32, "zoomed"), (1, 2, 39, 50, 32, 16, "zoomed"),
            (1, 2, 41, 57, 16, 8, "zoomed"), (1, 2, 43, 61, 8, 4, "zoomed")]


@pytest.mark.parametrize("B,V,H,W,C,D,kind",
                         [(*shape, "default") for shape in WARP_SHAPES] + K8_CASES)
def test_warp_corr_bwd_matches_plain(dev, B, V, H, W, C, D, kind):
    rng = np.random.default_rng(8)
    args = warp_inputs(dev, rng, B, V, H, W, C, D, kind)
    dcorr = torch.from_numpy(rng.standard_normal((B, V, 8, D, H, W)).astype(np.float32)).to(dev)
    before = cuda_build.LAUNCHES["warp_corr_bwd"]
    dref, dsrc = warp_corr_bwd(*args, dcorr, groups=8)
    assert cuda_build.LAUNCHES["warp_corr_bwd"] == before + 1
    want_dref, want_dsrc = warp_corr_bwd_plain(*args, dcorr, groups=8)
    # fp32 atomics: the order of every sum varies from run to run, so the
    # bound is relative to each output's scale, not bit for bit.
    for got, want in ((dref, want_dref), (dsrc, want_dsrc)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float(dsrc.abs().max()) > 0


def test_warp_corr_train_gradcheck(dev):
    """Finite differences through K7 against K8. The correlation is linear
    in ref for a fixed src and in src for a fixed ref, so fp32 central
    differences are exact up to rounding. K8's atomics sum in an order that
    varies from run to run, so two backward passes may differ in their last
    bits (values of order 1 here): gradcheck's reentrancy check gets that
    much room."""
    rng = np.random.default_rng(9)
    ref, src, sp, rp, dv = warp_inputs(dev, rng, 1, 2, 5, 7, 8, 3)
    assert torch.autograd.gradcheck(
        lambda r, s: WarpCorrTrain.apply(r, s, sp, rp, dv, 8),
        (ref.requires_grad_(), src.requires_grad_()), eps=1e-2, atol=2e-3, rtol=1e-3,
        nondet_tol=1e-5, fast_mode=True)


def test_warp_corr_train_is_the_adjoint_of_k7(dev):
    """<dcorr, K7(u, src)> = <u, dref> and <dcorr, K7(ref, u)> = <u, dsrc>
    at a stage-sized shape: the backward is the exact adjoint of the
    forward (tests/test_pallas_warp.py's dot-product test)."""
    rng = np.random.default_rng(10)
    ref, src, sp, rp, dv = warp_inputs(dev, rng, 2, 3, 40, 52, 32, 8)
    u_ref, u_src = torch.randn_like(ref), torch.randn_like(src)
    ref.requires_grad_()
    src.requires_grad_()
    corr = WarpCorrTrain.apply(ref, src, sp, rp, dv, 8)
    dcorr = torch.randn_like(corr)
    corr.backward(dcorr)
    with torch.no_grad():
        lhs_r = float((dcorr.double() * warp_corr_fwd(u_ref, src, sp, rp, dv).double()).sum())
        lhs_s = float((dcorr.double() * warp_corr_fwd(ref, u_src, sp, rp, dv).double()).sum())
    rhs_r = float((u_ref.double() * ref.grad.double()).sum())
    rhs_s = float((u_src.double() * src.grad.double()).sum())
    assert abs(lhs_r - rhs_r) <= 1e-4 * max(1.0, abs(lhs_r))
    assert abs(lhs_s - rhs_s) <= 1e-4 * max(1.0, abs(lhs_s))


def test_training_warp_raises_instead_of_falling_back(dev):
    rng = np.random.default_rng(11)
    ref, src, sp, rp, dv = warp_inputs(dev, rng, 1, 2, 8, 8, 8, 4)
    dcorr = torch.zeros((1, 2, 8, 4, 8, 8), device=dev)
    with pytest.raises(ValueError):  # a CPU projection among CUDA tensors
        warp_corr_fwd(ref, src, sp.cpu(), rp, dv)
    with pytest.raises(TypeError):  # float64 is not taken
        warp_corr_fwd(ref.double(), src.double(), sp, rp, dv.double())
    with pytest.raises(ValueError):  # C = 12 has no kernel
        warp_corr_fwd(ref[..., :6].repeat(1, 1, 1, 2).contiguous(),
                      src[..., :6].repeat(1, 1, 1, 1, 2).contiguous(), sp, rp, dv)
    with pytest.raises(ValueError):  # groups must be 8
        warp_corr_fwd(ref, src, sp, rp, dv, groups=4)
    with pytest.raises(ValueError):  # dcorr of the wrong shape
        warp_corr_bwd(ref, src, sp, rp, dv, dcorr[:, :1])
    with pytest.raises(TypeError):  # float64 cotangent
        warp_corr_bwd(ref, src, sp, rp, dv, dcorr.double())
    with pytest.raises(ValueError):  # a CPU cotangent
        warp_corr_bwd(ref, src, sp, rp, dv, dcorr.cpu())


def test_save_depth_on_the_card_matches_the_cpu(dev, tmp_path):
    """The whole of save_depth (dataset, forward with K1-K6, metrics, the
    stacked confidences' nearest resize, the writes) at chip_smoke.py's small
    shape: depth and confidence within the forward's card-to-CPU bounds,
    cams and images byte-equal."""
    import chip_smoke

    ok, errs = chip_smoke.save_depth_card_vs_cpu(torch, str(tmp_path), dev.type)
    assert ok, errs


@pytest.mark.parametrize("method", ["pcd", "dpcd", "gipuma"])
def test_fuse_scan_on_the_card_matches_the_cpu(dev, tmp_path, method):
    """Fusion of a plane's exact depth maps (chip_smoke.py's scene at
    150x225, 6 views) on the card and on the CPU: the same masks but for at
    most 1e-4 of the pixels, the same points where both keep, nearly all of
    the interior kept, and the points on the plane."""
    import chip_smoke
    from mvsformer_torch.fuse import fuse_scan
    from mvsformer_torch.utils.ply import read_ply

    data = chip_smoke.write_dtu_scan(str(tmp_path), img_hw=(150, 225))
    pair = os.path.join(data, "scan1")
    plane = str(tmp_path / "plane")
    saved = str(tmp_path / "saved")
    for sub in ("depth_est", "confidence", "cams", "images"):
        os.makedirs(os.path.join(saved, sub))
    for v in range(chip_smoke.PIPE_VIEWS):
        vid = f"{v:0>8}"
        cam = read_cam_file(os.path.join(pair, "cams", f"{vid}_cam.txt"))
        write_cam_file(os.path.join(saved, "cams", f"{vid}_cam.txt"), cam)
        save_pfm(os.path.join(saved, "depth_est", f"{vid}.pfm"), np.zeros((150, 225), np.float32))
        np.save(os.path.join(saved, "confidence", f"{vid}.npy"), np.zeros((150, 225), np.float32))
        write_png(os.path.join(saved, "images", f"{vid}.jpg"),
                  read_image(os.path.join(pair, "images", f"{vid}.jpg")))
    chip_smoke.plane_folder(saved, plane)
    rows = chip_smoke.fusion_card_vs_cpu(torch, pair, plane, method, dev.type)
    assert min(r["kept_interior"] for r in rows) > chip_smoke.PIPE_KEEP_MIN
    assert min(r["mask_agree"] for r in rows) >= chip_smoke.PIPE_MASK_AGREE
    assert max(r["point_rel_err"] for r in rows) <= chip_smoke.PIPE_POINT_RTOL
    assert max(r["plane_rel_err"] for r in rows) <= chip_smoke.PIPE_PLANE_RTOL
    n = fuse_scan(pair, plane, str(tmp_path / "x.ply"), method=method, device=dev,
                  logger=lambda *a: None)
    points, colors = read_ply(str(tmp_path / "x.ply"))
    assert n == points.shape[0] > 0 and colors.shape == points.shape


def hold_recorded_calls(specs, recorded, want):
    """Every recorded launch of each kernel against its plain version."""
    for name, calls in recorded.items():
        assert len(calls) == want[name], name
        for i, (args, kwargs) in enumerate(calls):
            with torch.no_grad():
                got = specs[name]["kernel"](*args, **kwargs)
                ref = specs[name]["plain"](*args, **kwargs)
            ok, err, detail, tol = specs[name]["compare"](got, ref)
            assert ok, f"{name} call {i}: {detail} (tolerance {tol})"


def test_validation_forward_at_b8_matches_plain(dev):
    """The validation batch of the training run (B=8, 5 views, 512x640, 192
    depths): every launch of K1-K6 in one eval forward against its plain
    version, at chip_smoke.py's tolerances."""
    import chip_smoke
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    model = build_model(ModelConfig(), device=dev)
    random_init_(model, torch.Generator().manual_seed(0))
    specs = chip_smoke.eval_kernel_specs(model)
    request = chip_smoke.synthetic_request(torch, 8, 5, 512, 640, device=dev)
    recorded, (depth, conf, _) = chip_smoke.record_calls(torch, specs, make_infer_fn(model),
                                                         *request)
    assert depth.shape == (8, 512, 640) and bool(torch.isfinite(depth).all())
    hold_recorded_calls(specs, recorded, chip_smoke.EVAL_PER_BATCH)


def test_training_micro_batch_at_a_non_512_crop_matches_plain(dev):
    """One training micro-batch at 768x1024 (B=1, 5 views, 192 depths):
    every launch of K7 and K8 against its plain version, and a finite loss
    and gradient."""
    import chip_smoke
    from mvsformer_torch.config import Config
    from mvsformer_torch.models.mvsformer import build_model, random_init_
    from mvsformer_torch.train.step import TrainStep

    cfg = Config()
    model = build_model(cfg.arch, device=dev, train=True)
    random_init_(model, torch.Generator().manual_seed(1))
    step = TrainStep(model, cfg, seed=0)
    specs = chip_smoke.train_kernel_specs(per_step=None)
    batch = chip_smoke.synthetic_batch(torch, 1, 5, 768, 1024, device=dev, with_gt=True)
    recorded, metrics = chip_smoke.record_calls(torch, specs, step, batch)
    assert np.isfinite(metrics["loss"]) and metrics["micro_batches"] == 1
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
               if p.grad is not None)
    hold_recorded_calls(specs, recorded, chip_smoke.TRAIN_PER_MICRO)


def island_cases(dev):
    """(name, wrapper, args, kwargs) of K2, K4, K5 and K6 with bf16
    activations and weights and fp32 folded BN, as the bf16 model calls
    them."""
    rng = np.random.default_rng(21)
    t = tensor(dev)
    b = lambda x: x.bfloat16()
    ent, (k0, k1, k2, k3, b3, folds) = vis_inputs(rng, dev, 2, 40, 70)
    k00, f00, k01, f01, kd, fd = head_weights(rng, t)
    w1, b1, k3l, b3l, fold = level_weights(rng, t, 16, 16)
    q, kv = t(rng.standard_normal((2, 300, 64))), t(rng.standard_normal((2, 100, 128)))
    return [
        ("visibility_net", visibility_net,
         (b(ent), b(k0), b(k1), b(k2), b(k3), b(b3), folds), {}),
        ("encoder_head", encoder_head,
         (b(t(rng.standard_normal((2, 3, 37, 45)))), b(k00), f00, b(k01), f01, b(kd), fd), {}),
        ("fpn_level", fpn_level,
         (b(t(rng.standard_normal((1, 64, 7, 9)))), b(t(rng.standard_normal((1, 16, 14, 18)))),
          b(w1), b(b1), b(k3l), b(b3l), fold), {"emit_intra": True}),
        ("gsa_attention", gsa_attention, (b(q), b(kv[..., :64]), b(kv[..., 64:]), 2), {}),
    ]


@pytest.mark.parametrize("case", range(4), ids=["K2", "K4", "K5", "K6"])
def test_island_kernels_take_bf16(dev, case):
    """The bf16 mode's fp32 islands: with bf16 inputs each of K2, K4, K5
    and K6 launches its fp32 kernel once on the inputs cast up and returns
    that result cast to bf16 (K2's weight stays fp32), bit for bit."""
    name, wrapper, args, kwargs = island_cases(dev)[case]
    before = cuda_build.LAUNCHES[name]
    got = wrapper(*args, **kwargs)
    assert cuda_build.LAUNCHES[name] == before + 1
    want = wrapper(*cuda_build.up_cast(args), **kwargs)
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for g, w in zip(got, want):
        assert w.dtype == torch.float32
        assert g.dtype == (torch.float32 if name == "visibility_net" else torch.bfloat16)
        assert torch.equal(g, w.to(g.dtype)), name


def test_bf16_forward_on_the_card_runs_every_eval_kernel(dev):
    """The bf16 TwinMVSNet eval forward (the default ModelConfig, 3 views,
    128x128, 192 depths): K1-K6 launch as in fp32 (K1 and K3 on fp32
    inputs, K2/K4/K5/K6 on bf16 inputs cast up), the outputs are fp32 and
    finite, and they lie within 1 depth unit (over 425-900) and 5e-3 in
    confidence of the fp32 model's on the same weights. On the CPU the same
    two models differ by 0.21 and 6.8e-4 at most."""
    import chip_smoke
    from mvsformer_torch.config import ModelConfig
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    cfg = ModelConfig()
    m32 = random_init_(build_model(cfg, device=dev), torch.Generator().manual_seed(0))
    m16 = build_model(cfg, device=dev, dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    request = chip_smoke.synthetic_request(torch, 1, 3, 128, 128, device=dev)
    cuda_build.reset_launches()
    depth, conf, _ = make_infer_fn(m16)(*request)
    counts = dict(cuda_build.LAUNCHES)
    assert all(counts.get(k, 0) == 4 for k in ("warp_group_corr", "visibility_net",
                                               "depth_decode")), counts
    assert counts.get("encoder_head") == 1 and counts.get("fpn_level") == 3, counts
    assert counts.get("gsa_attention") == 9, counts
    assert depth.dtype == conf.dtype == torch.float32
    assert bool(torch.isfinite(depth).all()) and bool(((conf > 0) & (conf <= 1)).all())
    depth32, conf32, _ = make_infer_fn(m32)(*request)
    assert float((depth - depth32).abs().max()) <= 1.0
    assert float((conf - conf32).abs().max()) <= 5e-3


def test_view_split_on_one_card_matches_the_serial_request(dev, tmp_path):
    """chip_smoke.py's 16a at a toy size: two gloo ranks on this one card,
    view 2 (the default widths, ndepths 8/4/4/2, 5 views, 64x64: 2 sources
    a rank), each rank's depth and confidence within the card-to-CPU
    bounds (1e-2, 1e-4) of the serial request on the card and of each
    other (cuDNN's transposed 3D convs are not deterministic), and K1-K3
    launched once a stage on each rank."""
    from mvsformer_torch.infer import make_infer_fn
    from mvsformer_torch.models.mvsformer import build_model, random_init_

    from test_torch_parallel_ranks import run_ranks, train_config

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.standard_normal((1, 5, 64, 64, 3)).astype(np.float32))
    K = np.array([[80.0, 0, 16], [0, 80.0, 16], [0, 0, 1]], np.float32)
    projs = {}
    for s, scale in zip(range(1, 5), (1 / 8, 1 / 4, 1 / 2, 1.0)):
        c = np.zeros((1, 5, 2, 4, 4), np.float32)
        for v in range(5):
            c[0, v, 0] = np.eye(4)
            c[0, v, 0, 0, 3] = 2.0 * v
            c[0, v, 1, :3, :3] = K * scale
            c[0, v, 1, 2, 2] = c[0, v, 1, 3, 3] = 1.0
        projs[f"stage{s}"] = torch.from_numpy(c)
    dv = torch.linspace(425, 900, 48)[None]
    model = random_init_(build_model(train_config("BN").arch, device="cpu"),
                         torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    torch.save((imgs, projs, dv), tmp_path / "request.pt")
    depth, conf, _ = make_infer_fn(model.to(dev))(imgs, projs, dv)
    ranks = run_ranks(tmp_path, 2, dict(kind="eval", data=1, view=2, device="cuda:0",
                                        weights=str(tmp_path / "weights.pt"),
                                        request=str(tmp_path / "request.pt"),
                                        tmps=[5.0, 5.0, 5.0, 1.0]))
    for r in ranks:
        assert float((r["depth"] - depth.cpu()).abs().max()) <= 1e-2
        assert float((r["conf"] - conf.cpu()).abs().max()) <= 1e-4
        assert all(r["launches"].get(k) == 4 for k in ("warp_group_corr", "visibility_net",
                                                       "depth_decode")), r["launches"]
    assert float((ranks[0]["depth"] - ranks[1]["depth"]).abs().max()) <= 1e-2
    assert float((ranks[0]["conf"] - ranks[1]["conf"]).abs().max()) <= 1e-4
