"""The port's modules against their flax counterparts (CPU, fp32, eval).

Weights come from the flax init with every bias, norm scale and BN running
stat randomised, and reach the port through the weight bridge. Inputs are
made with numpy; maps are NHWC on the JAX side and NCHW (NCDHW) here.
"""

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from mvsformer_tpu.models import blocks as jblocks
from mvsformer_tpu.models import costreg as jcostreg
from mvsformer_tpu.models import decoders as jdecoders
from mvsformer_tpu.models import fpn as jfpn
from mvsformer_tpu.models import twins as jtwins

from mvsformer_torch.models import blocks, costreg, decoders, fpn, twins
from mvsformer_torch.utils import convert_weights as cw
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()


def randomise(tree, stats, rng):
    """Random biases, norm scales and BN running stats in flax variables."""
    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, (s or {}).get(k))
            elif k == "bias":
                p[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "scale":
                p[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if s is not None and "mean" in s:
            s["mean"] = (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32)
            s["var"] = (1 + 0.2 * np.abs(rng.standard_normal(s["var"].shape))).astype(np.float32)
    walk(tree, stats)


def init(module, rng, *inputs, **kw):
    v = jax.jit(lambda k, *xs: module.init(k, *xs, **kw))(
        jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs])
    v = jax.tree.map(np.array, flax.core.unfreeze(v))
    v.setdefault("batch_stats", {})
    randomise(v["params"], v["batch_stats"], rng)
    return v


def run_jax(module, v, *inputs, **kw):
    return jax.jit(lambda v_, *xs: module.apply(v_, *xs, **kw))(
        v, *[jnp.asarray(x) for x in inputs])


def load(mod, sd):
    mod.load_state_dict(cw.to_torch(sd), strict=True)
    return mod.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def close(got, want, rtol=1e-5, atol=1e-5):
    """got: torch NC...; want: JAX N...C."""
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=rtol, atol=atol)


def block_state(v, **kw):
    sd = {}
    cw._conv_block(sd, "blk", v["params"], v["batch_stats"], **kw)
    return {k[len("blk."):]: x for k, x in sd.items()}


# -------------------------------------------------------------- blocks

@pytest.mark.parametrize("kind", ["conv_norm_act", "conv_bn_relu"])
def test_2d_conv_blocks_match_flax(rng, kind):
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32)
    if kind == "conv_norm_act":
        jmod, mod = (jblocks.ConvNormAct(16, kernel=5, stride=2, dtype=jnp.float32),
                     blocks.ConvNormAct(4, 16, 5, stride=2))
    else:
        jmod, mod = jblocks.ConvBnReLU(16, dtype=jnp.float32), blocks.ConvBnReLU(4, 16)
    v = init(jmod, rng, x, training=False)
    close(load(mod, block_state(v))(nchw(x)), run_jax(jmod, v, x, training=False))


@pytest.mark.parametrize("stride", [2, (1, 2, 2)])
def test_3d_conv_and_deconv_blocks_match_flax(rng, stride):
    x = rng.standard_normal((1, 4, 6, 8, 8)).astype(np.float32)
    jconv = jblocks.Conv3dNormAct(16, stride=stride, dtype=jnp.float32)
    v = init(jconv, rng, x, training=False)
    y = run_jax(jconv, v, x, training=False)
    close(load(blocks.Conv3dNormAct(8, 16, stride=stride), block_state(v))(nchw(x)), y)

    jdec = jblocks.Deconv3dNormAct(8, stride=stride, dtype=jnp.float32)
    y = np.asarray(y)
    v = init(jdec, rng, y, training=False)
    want = run_jax(jdec, v, y, training=False)
    close(load(blocks.Deconv3dNormAct(16, 8, stride), block_state(v, deconv=True))(nchw(y)),
          want)
    seq = block_state(v, deconv=True, conv_key="0", bn_key="1")
    close(load(blocks.Deconv3dSeq(16, 8, stride), seq)(nchw(y)), want)


def test_deconv2d_block_matches_flax(rng):
    x = rng.standard_normal((2, 3, 5, 24)).astype(np.float32)
    jmod = jblocks.Deconv2dNormAct(40, act=fnn.gelu, dtype=jnp.float32)
    v = init(jmod, rng, x, training=False)
    sd = block_state(v, deconv=True, conv_key="0", bn_key="1")
    close(load(blocks.Deconv2dNormAct(24, 40, blocks.gelu_tanh()), sd)(nchw(x)),
          run_jax(jmod, v, x, training=False))


# ----------------------------------------------------------------- FPN

def test_fpn_encoder_and_decoder_match_flax(rng):
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    jenc = jfpn.FPNEncoder(dtype=jnp.float32)
    v = init(jenc, rng, x, training=False)
    want = run_jax(jenc, v, x, training=False)
    enc = load(fpn.FPNEncoder(), cw.encoder_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = enc(nchw(x))
    for g, w in zip(got, want):
        close(g, w, atol=1e-4)

    feats = [np.asarray(w) for w in want]
    jdec = jfpn.FPNDecoder(dtype=jnp.float32)
    v = init(jdec, rng, *feats, training=False)
    want = run_jax(jdec, v, *feats, training=False)
    dec = load(fpn.FPNDecoder(), cw.fpn_decoder_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = dec(*[nchw(f) for f in feats])
    for g, w in zip(got, want):
        close(g, w, atol=1e-4)


# ------------------------------------------------------ Twins backbone

def test_altgvt_small_matches_flax(rng):
    """Full-width alt_gvt_small on a 32x48 input: windows padded on both
    axes (the pad-mask bias), sr 8/4/2 sub-sampled keys and the sr=1 stage."""
    x = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    jmod = jtwins.alt_gvt_small(dtype=jnp.float32)
    v = init(jmod, rng, x)
    want = run_jax(jmod, v, x)
    mod = load(twins.build_twins("alt_gvt_small"), cw.twins_state(v["params"]))
    with torch.no_grad():
        got = mod(nchw(x))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=1e-4)  # 18 blocks of fp32 matmuls


def test_twin_decoder_stage4_matches_flax(rng):
    xs = [rng.standard_normal(s).astype(np.float32) for s in
          ((2, 8, 16, 64), (2, 4, 8, 128), (2, 2, 4, 256), (2, 1, 2, 512))]
    jmod = jdecoders.TwinDecoderStage4(dtype=jnp.float32)
    v = init(jmod, rng, *xs, training=False)
    want = run_jax(jmod, v, *xs, training=False)
    mod = load(decoders.TwinDecoderStage4(),
               cw.twin_decoder_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        close(mod(*[nchw(x) for x in xs]), want, atol=1e-4)


# ------------------------------------------------------ cost-reg U-Nets

@pytest.mark.parametrize("three_d", [False, True])
def test_cost_reg_unets_match_flax(rng, three_d):
    D = 4 if three_d else 16
    x = rng.standard_normal((1, D, 8, 16, 8)).astype(np.float32)
    jmod = (jcostreg.CostRegNet3D if three_d else jcostreg.CostRegNet)(dtype=jnp.float32)
    v = init(jmod, rng, x, training=False)
    want = run_jax(jmod, v, x, training=False)  # eval: the depth-packed form
    mod = load((costreg.CostRegNet3D if three_d else costreg.CostRegNet)(8, 8),
               cw.cost_reg_state(v["params"], v["batch_stats"], three_d))
    with torch.no_grad():
        got = mod(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    close(got, want, atol=1e-4)


def test_cost_reg_net_trains_as_flax(rng):
    """Train-mode CostRegNet at D = 16 (stages 1-2 of the DTU config run it)
    against flax with training=True, on a batch of two: the batch-statistics
    output, the gradients of a random cotangent in the input and in every
    weight, and the running statistics the forward leaves."""
    x = rng.standard_normal((2, 16, 8, 16, 8)).astype(np.float32)
    jmod = jcostreg.CostRegNet(dtype=jnp.float32)
    v = init(jmod, rng, x, training=False)
    ct = rng.standard_normal((2, 16, 8, 16, 1)).astype(np.float32)

    def loss(params, xx):
        out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, xx,
                              training=True, mutable=["batch_stats"])
        return (out * ct).sum(), (out, upd["batch_stats"])

    (_, (want, new_stats)), (gparams, gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    mod = load(costreg.CostRegNet(8, 8), cw.cost_reg_state(v["params"], v["batch_stats"], False))
    mod.train()
    xt = nchw(x).requires_grad_()
    got = mod(xt)
    (got * nchw(ct)).sum().backward()
    # fp32 sums of 3x3x3 convs and batch statistics over 2x16x8x16 voxels,
    # in another order on each side (outputs and input gradients of scale ~4).
    close(got, want, atol=1e-4)
    close(xt.grad, gx, atol=1e-4)
    want_grads = cw.cost_reg_state(jax.tree.map(np.asarray, gparams), v["batch_stats"], False)
    named = dict(mod.named_parameters())
    assert set(named) <= set(want_grads)
    for name, p in named.items():
        w = np.asarray(want_grads[name])
        # A weight's gradient sums over every voxel: bound it by its scale.
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)
    want_stats = cw.cost_reg_state(v["params"], jax.tree.map(np.asarray, new_stats), False)
    buffers = {k: b for k, b in mod.named_buffers() if k.endswith(("running_mean", "running_var"))}
    assert buffers
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), np.asarray(want_stats[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
