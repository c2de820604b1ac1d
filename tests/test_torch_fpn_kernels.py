"""K4 `encoder_head`, K5 `fpn_level` and the port's FPN against the JAX
package (CPU).

The plain versions (what the wrappers run for CPU tensors; the CUDA kernels
are held against them by tests/test_torch_cuda.py and chip_smoke.py on the
GPU) are compared with the Pallas kernels in interpret mode, the way
tests/test_encoder_head.py, tests/test_fpn_final.py and tests/test_fpn_up.py
run them, and the port's FPNEncoder + FPNDecoder with the JAX FPN at its
default flags (fused encoder head, fused level 2 and final level).
"""

import flax
import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mvsformer_tpu.models import fpn as jfpn
from mvsformer_tpu.ops.pallas.encoder_head import encoder_head as pallas_encoder_head
from mvsformer_tpu.ops.pallas.fpn_final import fpn_final_level
from mvsformer_tpu.ops.pallas.fpn_final import fpn_level as pallas_fpn_level
from mvsformer_tpu.ops.pallas.fpn_up import fpn_up_level, interleave_h, pack_lateral, pack_prev

from mvsformer_torch.models import fpn
from mvsformer_torch.ops import cuda_build
from mvsformer_torch.ops.encoder_head import encoder_head, encoder_head_plain
from mvsformer_torch.ops.fpn_level import fpn_level, fpn_level_plain
from mvsformer_torch.utils import convert_weights as cw

torch.set_num_threads(2)

T = torch.from_numpy
F32 = np.float32


def nchw(x):
    return T(np.ascontiguousarray(np.moveaxis(np.asarray(x, F32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def hwio_to_torch(k):
    """flax conv kernel [kh, kw, I, O] -> torch [O, I, kh, kw]."""
    return T(np.ascontiguousarray(np.transpose(np.asarray(k, F32), (3, 2, 0, 1))))


def fold(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(F32), (rng.standard_normal(c) * 0.1).astype(F32))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ K4

def test_encoder_head_plain_matches_pallas_interpret():
    """tests/test_encoder_head.py's oracle inputs, through the port's wrapper
    on CPU tensors (the plain version; no launch is counted)."""
    rng = np.random.default_rng(11)
    N, H, W = 1, 16, 256
    img = rng.standard_normal((N, H, W, 3)).astype(F32)
    k7, k5, kd = [(rng.standard_normal(s) * 0.15).astype(F32)
                  for s in ((7, 7, 3, 8), (5, 5, 8, 8), (5, 5, 8, 16))]
    f00, f01, fd = fold(rng, 8), fold(rng, 8), fold(rng, 16)
    with pltpu.force_tpu_interpret_mode():
        latt, down0 = pallas_encoder_head(
            jnp.asarray(img), jnp.asarray(k7), tuple(map(jnp.asarray, f00)), jnp.asarray(k5),
            tuple(map(jnp.asarray, f01)), jnp.asarray(kd), tuple(map(jnp.asarray, fd)))
    want_c01 = np.asarray(latt).reshape(N, H, 2, 8, W // 2).transpose(0, 1, 4, 2, 3)
    want_c01 = want_c01.reshape(N, H, W, 8)

    args = (nchw(img), hwio_to_torch(k7), tuple(map(T, f00)), hwio_to_torch(k5),
            tuple(map(T, f01)), hwio_to_torch(kd), tuple(map(T, fd)))
    before = dict(cuda_build.LAUNCHES)
    conv01, d0 = encoder_head(*args)
    assert dict(cuda_build.LAUNCHES) == before
    torch.testing.assert_close((conv01, d0), encoder_head_plain(*args), rtol=0, atol=0)
    # fp32 on both sides: the tolerance tests/test_encoder_head.py uses.
    close(nhwc(conv01), want_c01, 2e-4)
    close(nhwc(d0), down0, 2e-4)


# ------------------------------------------------------------------ K5

def level_params(rng, cl, co):
    """flax-layout (w1 [1,1,cl,64], b1, k3 [3,3,64,co], b3, (mul, add))."""
    return ((rng.standard_normal((1, 1, cl, 64)) * 0.3).astype(F32),
            (rng.standard_normal(64) * 0.1).astype(F32),
            (rng.standard_normal((3, 3, 64, co)) * 0.1).astype(F32),
            (rng.standard_normal(co) * 0.1).astype(F32), fold(rng, co))


def jax_level(p):
    w1, b1, k3, b3, (mul, add) = p
    return (jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(k3), jnp.asarray(b3),
            (jnp.asarray(mul), jnp.asarray(add)))


def port_level(p):
    w1, b1, k3, b3, (mul, add) = p
    return hwio_to_torch(w1), T(b1), hwio_to_torch(k3), T(b3), (T(mul), T(add))


def test_fpn_final_level_plain_matches_pallas_interpret():
    """cl = co = 8 (the final level), tests/test_fpn_final.py's recipe."""
    rng = np.random.default_rng(7)
    N, h, w = 1, 8, 128
    intra2 = rng.standard_normal((N, h, w, 64)).astype(F32)
    lateral = rng.standard_normal((N, 2 * h, 2 * w, 8)).astype(F32)
    p = level_params(rng, 8, 8)
    with pltpu.force_tpu_interpret_mode():
        want = fpn_final_level(jnp.asarray(intra2), jnp.asarray(lateral), *jax_level(p))
    before = dict(cuda_build.LAUNCHES)
    got = fpn_level(nchw(intra2), nchw(lateral), *port_level(p))
    assert dict(cuda_build.LAUNCHES) == before
    close(nhwc(got), want, 2e-4)


def test_fpn_level2_chain_with_intra_matches_pallas_interpret():
    """Level 2 (cl = co = 16) emits intra', which feeds the final level
    (cl = co = 8): the chained pair of tests/test_fpn_final.py."""
    rng = np.random.default_rng(7)
    N, h, w = 1, 8, 128
    intra1 = rng.standard_normal((N, h, w, 64)).astype(F32)
    lat2 = rng.standard_normal((N, 2 * h, 2 * w, 16)).astype(F32)
    lat3 = rng.standard_normal((N, 4 * h, 4 * w, 8)).astype(F32)
    p2, p3 = level_params(rng, 16, 16), level_params(rng, 8, 8)
    with pltpu.force_tpu_interpret_mode():
        out2_want, intra_cw = pallas_fpn_level(jnp.asarray(intra1), jnp.asarray(lat2),
                                               *jax_level(p2), emit_intra=True)
        out3_want = pallas_fpn_level(intra_cw, jnp.asarray(lat3), *jax_level(p3))
    out2, intra = fpn_level_plain(nchw(intra1), nchw(lat2), *port_level(p2), emit_intra=True)
    out3 = fpn_level_plain(intra, nchw(lat3), *port_level(p3))
    close(nhwc(out2), out2_want, 2e-4)
    close(intra.numpy(), np.asarray(intra_cw).transpose(0, 2, 1, 3), 2e-4)  # CW -> NCHW
    close(nhwc(out3), out3_want, 2e-4)


def randomise(tree, stats, rng):
    """Random biases and BN affines and running stats in flax variables, so
    the BN folding is exercised."""
    for k, v in tree.items():
        if isinstance(v, dict):
            randomise(v, (stats or {}).get(k), rng)
        elif k == "bias":
            tree[k] = (0.05 * rng.standard_normal(v.shape)).astype(F32)
        elif k == "scale":
            tree[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(F32)
    if stats is not None and "mean" in stats:
        stats["mean"] = (0.1 * rng.standard_normal(stats["mean"].shape)).astype(F32)
        stats["var"] = (1 + 0.2 * np.abs(rng.standard_normal(stats["var"].shape))).astype(F32)


def flax_init(module, rng, *inputs):
    v = module.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs), training=False)
    v = jax.tree.map(lambda a: np.array(a, F32), flax.core.unfreeze(v))
    randomise(v["params"], v["batch_stats"], rng)
    return v


def test_fpn_level_one_matches_fpn_up_level_and_the_xla_decoder():
    """K5 at level 1 (cl = co = 32) against `fpn_up_level` in interpret mode
    (bf16 inside, so within 2e-2 of the output's scale, the bound of
    tests/test_fpn_up.py) and against the fp32 XLA FPNDecoder (2e-4)."""
    rng = np.random.default_rng(0)
    B, H, W = 1, 192, 32  # fpn_up_level needs H/8 >= 24
    shapes = [(B, H, W, 8), (B, H // 2, W // 2, 16), (B, H // 4, W // 4, 32),
              (B, H // 8, W // 8, 64)]
    feats = [rng.standard_normal(s).astype(F32) for s in shapes]
    jdec = jfpn.FPNDecoder(norm="BN", dtype=jnp.float32)
    v = flax_init(jdec, rng, *feats)
    xla_out1 = np.asarray(jdec.apply(v, *map(jnp.asarray, feats), training=False)[1])
    p, bs = v["params"], v["batch_stats"]
    bn = p["out1"]["Norm_0"]["BatchNorm_0"], bs["out1"]["Norm_0"]["BatchNorm_0"]
    out_ph, _ = fpn_up_level(
        pack_prev(jnp.asarray(feats[3])), pack_lateral(jnp.asarray(feats[2])),
        p["inner1"]["kernel"], p["inner1"]["bias"], p["out1"]["Conv_0"]["kernel"],
        p["out1"]["Conv_0"]["bias"], (bn[0]["scale"], bn[0]["bias"], bn[1]["mean"], bn[1]["var"]),
        emit_intra=False, interpret=True)
    pallas_out1 = np.asarray(interleave_h(out_ph).astype(jnp.float32))

    dec = fpn.FPNDecoder().eval()
    dec.load_state_dict(cw.to_torch(cw.fpn_decoder_state(p, bs)))
    with torch.no_grad():
        got = nhwc(dec._level(1, nchw(feats[3]), nchw(feats[2]), False))
    close(got, xla_out1, 2e-4)
    scale = np.abs(xla_out1).max()
    assert np.abs(got - pallas_out1).max() / scale < 2e-2


def test_fpn_matches_the_jax_fpn_with_its_fused_flags_on(monkeypatch):
    """The port's FPNEncoder + FPNDecoder against the JAX FPN with
    fused_head, fused_final and fused_l2 on, run as
    tests/test_fpn_final.py runs the fused chain: the TPU gate patched open
    and the Pallas kernels in interpret mode. 32x512 is the smallest shape
    where every gate opens (H % 16, W % 512)."""
    monkeypatch.setattr(jfpn, "_on_tpu", lambda: True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 32, 512, 3)).astype(F32)
    jenc = jfpn.FPNEncoder(norm="BN", dtype=jnp.float32, fused_head=True)
    jdec = jfpn.FPNDecoder(norm="BN", dtype=jnp.float32, fused_final=True, fused_l2=True)
    ev = flax_init(jenc, rng, x)  # init runs the XLA path: the same variables
    feats = jfpn.FPNEncoder(norm="BN", dtype=jnp.float32).apply(ev, jnp.asarray(x),
                                                               training=False)
    dv = flax_init(jdec, rng, *feats)
    with pltpu.force_tpu_interpret_mode():
        want = jdec.apply(dv, *jenc.apply(ev, jnp.asarray(x), training=False),
                          training=False)

    enc, dec = fpn.FPNEncoder().eval(), fpn.FPNDecoder().eval()
    enc.load_state_dict(cw.to_torch(cw.encoder_state(ev["params"], ev["batch_stats"])))
    dec.load_state_dict(cw.to_torch(cw.fpn_decoder_state(dv["params"], dv["batch_stats"])))
    with torch.no_grad():
        got = dec(*enc(nchw(x)))
    for g, w_, name in zip(got, want, ("out0", "out1", "out2", "out3")):
        np.testing.assert_allclose(nhwc(g), np.asarray(w_), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
