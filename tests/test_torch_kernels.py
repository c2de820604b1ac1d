"""The plain versions of the port's three kernels against the JAX functions
that define their contracts, and against the Pallas kernels run the way the
JAX package's own tests run them on the CPU (CPU tensors; the CUDA kernels
themselves are held against these plain versions by tests/test_torch_cuda.py
and chip_smoke.py on the GPU).
"""

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mvsformer_tpu.models.stagenet import VisibilityNet as JaxVisibilityNet
from mvsformer_tpu.ops import correlation as jcorr
from mvsformer_tpu.ops import geometry as jgeo
from mvsformer_tpu.ops import regression as jreg
from mvsformer_tpu.ops.pallas.stage_tail import fused_depth_decode
from mvsformer_tpu.ops.pallas.vis_net import fused_visibility

from mvsformer_torch.models.stagenet import VisibilityNet
from mvsformer_torch.ops.stage_tail import depth_decode, depth_decode_plain
from mvsformer_torch.ops.vis_net import visibility_net_plain
from mvsformer_torch.ops.warp_corr import warp_group_corr, warp_group_corr_plain
from mvsformer_torch.utils.convert_weights import to_torch, vis_state
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

T = torch.from_numpy


# ------------------------------------------------------------------ K1

def cameras(rng, B, V, H, W):
    """Raw [B, V, 2, 4, 4] camera stacks: shared K, translated and slightly
    rotated source views, so part of every warp falls outside the image."""
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    cams = np.zeros((B, V + 1, 2, 4, 4), np.float32)
    for b in range(B):
        for v in range(V + 1):
            ang = 0.0 if v == 0 else rng.uniform(-0.05, 0.05)
            c, s = np.cos(ang), np.sin(ang)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            ext[0, 3] = 0.0 if v == 0 else rng.uniform(-3, 3)
            cams[b, v, 0] = ext
            cams[b, v, 1, :3, :3] = K
            cams[b, v, 1, 3, 3] = 1.0
    return cams


@pytest.mark.parametrize("pixelwise", [True, False])
def test_warp_group_corr_plain_matches_jax_chain(rng, pixelwise):
    """K1's contract: per view, geometry.homo_warp -> groupwise_correlation
    -> entropy_over_depth, on composed projections, for V = 2 views."""
    B, V, H, W, C, D, G = 2, 2, 12, 20, 16, 6, 8
    ref = rng.standard_normal((B, H, W, C)).astype(np.float32)
    src = rng.standard_normal((B, V, H, W, C)).astype(np.float32)
    cams = cameras(rng, B, V, H, W)
    if pixelwise:
        dv = np.sort(rng.uniform(20, 60, (B, D, H, W)).astype(np.float32), axis=1)
    else:
        dv = np.sort(rng.uniform(20, 60, (B, D)).astype(np.float32), axis=1)
    full = np.array(jgeo.compose_projection(jnp.asarray(cams)))
    ref_full, src_full = full[:, 0], full[:, 1:]

    corr, ent = warp_group_corr(T(ref), T(src), T(src_full), T(ref_full), T(dv), groups=G)
    assert corr.shape == (B, V, G, D, H, W) and ent.shape == (B, V, H, W)
    for v in range(V):
        warped, _ = jgeo.homo_warp(jnp.asarray(src[:, v]), jnp.asarray(src_full[:, v]),
                                   jnp.asarray(ref_full), jnp.asarray(dv))
        want = jcorr.groupwise_correlation(jnp.asarray(ref), warped, G)  # [B,D,H,W,G]
        want_ent = jcorr.entropy_over_depth(want)[..., 0]
        # fp32 both sides; coordinates ~1e2 agree to rounding and sampling is
        # continuous in them.
        np.testing.assert_allclose(corr[:, v].permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ent[:, v].numpy(), np.asarray(want_ent),
                                   rtol=1e-4, atol=1e-4)


def test_warp_group_corr_cpu_wrapper_is_the_plain_version(rng):
    B, V, H, W, C, D = 1, 3, 8, 10, 8, 4
    ref = T(rng.standard_normal((B, H, W, C)).astype(np.float32))
    src = T(rng.standard_normal((B, V, H, W, C)).astype(np.float32))
    full = T(np.array(jgeo.compose_projection(jnp.asarray(cameras(rng, B, V, H, W)))))
    dv = T(np.sort(rng.uniform(20, 60, (B, D, H, W)).astype(np.float32), axis=1))
    got = warp_group_corr(ref, src, full[:, 1:], full[:, 0], dv)
    want = warp_group_corr_plain(ref, src, full[:, 1:], full[:, 0], dv, 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ------------------------------------------------------------------ K2

def random_vis_variables(rng, ent):
    """flax VisibilityNet variables with randomised kernels and BN (the
    recipe of tests/test_vis_net.py), so the BN folding is exercised."""
    net = JaxVisibilityNet(norm="BN", dtype=jnp.float32)
    v = jax.tree.map(np.array, flax.core.unfreeze(net.init(jax.random.PRNGKey(0), ent, False)))

    def rk(a, s):
        return (rng.standard_normal(a.shape) * s).astype(np.float32)

    for c, fan in [("conv0", 9), ("conv1", 144), ("conv2", 144)]:
        v["params"][c]["Conv_0"]["kernel"] = rk(v["params"][c]["Conv_0"]["kernel"], fan ** -0.5)
        bn_p = v["params"][c]["Norm_0"]["BatchNorm_0"]
        bn_p["scale"] = 1.0 + rk(bn_p["scale"], 0.1)
        bn_p["bias"] = rk(bn_p["bias"], 0.1)
        bn_s = v["batch_stats"][c]["Norm_0"]["BatchNorm_0"]
        bn_s["mean"] = rk(bn_s["mean"], 0.3)
        bn_s["var"] = np.abs(rk(bn_s["var"], 1.0)) + 0.5
    v["params"]["conv3"]["kernel"] = rk(v["params"]["conv3"]["kernel"], 0.35)
    v["params"]["conv3"]["bias"] = rk(v["params"]["conv3"]["bias"], 0.1)
    return net, v


def port_vis(v):
    mod = VisibilityNet().eval()
    mod.load_state_dict(to_torch(vis_state(v["params"], v["batch_stats"])))
    return mod


@pytest.mark.parametrize("shape", [(1, 40, 256), (3, 9, 13)])
def test_visibility_net_plain_matches_flax(shape):
    rng = np.random.default_rng(0)
    ent = rng.standard_normal(shape + (1,)).astype(np.float32)
    net, v = random_vis_variables(rng, jnp.asarray(ent))
    want = np.asarray(net.apply(v, jnp.asarray(ent), False))[..., 0]
    with torch.no_grad():
        got = port_vis(v)(T(ent[..., 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # fp32 both sides


@pytest.mark.parametrize("shape,block_rows", [((1, 40, 256), 8), ((2, 32, 128), 12)])
def test_visibility_net_plain_matches_pallas_interpret(shape, block_rows):
    rng = np.random.default_rng(0)
    ent = rng.standard_normal(shape).astype(np.float32)
    _, v = random_vis_variables(rng, jnp.asarray(ent[..., None]))
    p, bs = v["params"], v["batch_stats"]

    def st(c):
        bp, bsn = p[c]["Norm_0"]["BatchNorm_0"], bs[c]["Norm_0"]["BatchNorm_0"]
        return (bp["scale"], bp["bias"], bsn["mean"], bsn["var"])

    want = fused_visibility(jnp.asarray(ent), p["conv0"]["Conv_0"]["kernel"],
                            p["conv1"]["Conv_0"]["kernel"], p["conv2"]["Conv_0"]["kernel"],
                            p["conv3"]["kernel"], p["conv3"]["bias"],
                            (st("conv0"), st("conv1"), st("conv2")),
                            block_rows=block_rows, interpret=True)
    mod = port_vis(v)
    folds = [mod[i].bn.folded() for i in range(3)]
    with torch.no_grad():
        got = visibility_net_plain(T(ent), mod[0].conv.weight, mod[1].conv.weight,
                                   mod[2].conv.weight, mod[3].weight, mod[3].bias, folds)
    # The Pallas kernel feeds its first conv in bf16 (vis_net.py:176), which
    # is the tolerance tests/test_vis_net.py gives it against flax.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=6e-3)


# ------------------------------------------------------------------ K3

@pytest.mark.parametrize("shape", [(1, 8, 24, 160), (2, 32, 16, 128)])
def test_depth_decode_plain_matches_jax_and_pallas_interpret(shape):
    rng = np.random.default_rng(3)
    B, D, H, W = shape
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    dv = np.sort(rng.uniform(400, 900, shape).astype(np.float32), axis=1)
    tmp = 5.0
    got_d, got_c = depth_decode(T(logits), T(dv), tmp)  # CPU: the plain version
    torch.testing.assert_close((got_d, got_c), depth_decode_plain(T(logits), T(dv), tmp))

    jl = jnp.asarray(logits)
    want_d, want_c = jreg.decode_depth(jl, jax.nn.softmax(jl, axis=1), jnp.asarray(dv),
                                       "ce", D, training=False, tmp=tmp)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)

    with pltpu.force_tpu_interpret_mode():
        k_d, k_c = fused_depth_decode(jl, jnp.asarray(dv), tmp)
    # The tolerances tests/test_stage_tail.py holds the Pallas kernel to.
    np.testing.assert_allclose(got_d.numpy(), np.asarray(k_d), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(k_c), rtol=1e-5, atol=1e-6)


def decode_partial(l, dv, tmp):
    """csrc/depth_decode.cu's partial (m, s1, st, ws) of the depths of one
    pass, [B, n, H, W] -> 4 x [B, H, W]: the max, then the sums from it."""
    m = l.amax(dim=1)
    x = l - m[:, None]
    et = torch.exp(tmp * x)
    return m, torch.exp(x).sum(dim=1), et.sum(dim=1), (et * dv).sum(dim=1)


def merge_partials(a, b, tmp):
    """The kernel's merge: the partial with the larger max keeps its sums,
    the other's are scaled by exp(m' - m) and exp(tmp (m' - m)); an empty
    partial (m = -inf) is the identity."""
    (ma, s1a, sta, wsa), (mb, s1b, stb, wsb) = a, b
    m = torch.maximum(ma, mb)
    one = torch.ones_like(m)
    ca, cb = (torch.where(mx == m, one, torch.exp(mx - m)) for mx in (ma, mb))
    ta, tb = (torch.where(mx == m, one, torch.exp(tmp * (mx - m))) for mx in (ma, mb))
    merged = (m, s1a * ca + s1b * cb, sta * ta + stb * tb, wsa * ta + wsb * tb)
    a_empty, b_empty = ma == -torch.inf, mb == -torch.inf
    return tuple(torch.where(b_empty, x, torch.where(a_empty, y, z))
                 for x, y, z in zip(a, b, merged))


def emulate_decode(l, dv, tmp, depths_per_pass, lanes):
    """K3's arithmetic in fp32 torch: lane r of a pixel's `lanes` takes the
    depths r, r + lanes, ... in passes of `depths_per_pass`, merging each
    pass into its running partial; the lanes then meet by xor butterflies,
    as the shuffles do, and lane 0's partial gives (depth, conf)."""
    B, D, H, W = l.shape
    empty = (torch.full((B, H, W), -torch.inf), torch.zeros(B, H, W), torch.zeros(B, H, W),
             torch.zeros(B, H, W))
    acc = []
    for r in range(lanes):
        mine = list(range(r, D, lanes))
        part = empty
        for i in range(0, len(mine), depths_per_pass):
            chunk = mine[i:i + depths_per_pass]
            part = merge_partials(part, decode_partial(l[:, chunk], dv[:, chunk], tmp), tmp)
        acc.append(part)
    off = 1
    while off < lanes:
        acc = [merge_partials(acc[r], acc[r ^ off], tmp) for r in range(lanes)]
        off *= 2
    _, s1, st, ws = acc[0]
    return ws / st, 1.0 / s1


# (D, depths a pass, lanes): the kernel's own two passes at D = 48; passes
# of 8 and of 4 depths; D = 32 over 4 lanes and 16 over 2; D = 3 and 1 over
# 4 lanes, where some lanes hold nothing. Logits x 3 and x 30.
@pytest.mark.parametrize("D,per_pass,lanes,scale", [
    (48, 32, 1, 3.0), (32, 8, 1, 3.0), (8, 4, 1, 30.0), (32, 8, 4, 3.0), (16, 4, 2, 30.0),
    (3, 4, 4, 3.0), (1, 4, 4, 3.0)])
def test_depth_decode_merge_matches_jax_and_pallas_interpret(D, per_pass, lanes, scale):
    rng = np.random.default_rng(5)
    shape = (2, D, 8, 128)
    logits = (rng.standard_normal(shape) * scale).astype(np.float32)
    dv = np.sort(rng.uniform(400, 900, shape).astype(np.float32), axis=1)
    tmp = 5.0
    got_d, got_c = emulate_decode(T(logits), T(dv), tmp, per_pass, lanes)

    jl = jnp.asarray(logits)
    want_d, want_c = jreg.decode_depth(jl, jax.nn.softmax(jl, axis=1), jnp.asarray(dv),
                                       "ce", D, training=False, tmp=tmp)
    with pltpu.force_tpu_interpret_mode():
        k_d, k_c = fused_depth_decode(jl, jnp.asarray(dv), tmp)
    # The tolerances tests/test_stage_tail.py holds the Pallas kernel to.
    for d, c in ((want_d, want_c), (k_d, k_c)):
        np.testing.assert_allclose(got_d.numpy(), np.asarray(d), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(c), rtol=1e-5, atol=1e-6)
