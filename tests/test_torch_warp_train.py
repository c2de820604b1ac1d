"""The training warp of the port, K7 `warp_corr_fwd` and K8 `warp_corr_bwd`
behind `WarpCorrTrain`, against the JAX package on the CPU.

K7's plain version is held to the XLA path (`geometry.homo_warp` then
`groupwise_correlation`) and to the Pallas `plane_sweep_group_corr_v3`,
`_v2` and `plane_sweep_group_corr` (v1) in interpret mode, at the in-band
geometry tests/test_pallas_warp.py uses; on Hopper the three have no band,
so all three close on K7. K8's plain version (autograd through the plain
forward) is held to `jax.vjp` of the XLA path and to the Pallas
`plane_sweep_group_corr_bwd` in interpret mode. The CUDA kernels themselves
are held to these plain versions by tests/test_torch_cuda.py and
chip_smoke.py on the GPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mvsformer_tpu.ops import correlation as jcorr
from mvsformer_tpu.ops import geometry as jgeo
from mvsformer_tpu.ops.pallas import warp_corr as jwarp
from mvsformer_tpu.ops.pallas.warp_corr_bwd import plane_sweep_group_corr_bwd
from mvsformer_tpu.ops.pallas.warp_corr_train import _bwd as fused_warp_corr_train_bwd

from mvsformer_torch.ops.correlation import entropy_over_depth
from mvsformer_torch.ops.warp_corr import warp_corr_fwd, warp_corr_fwd_plain
from mvsformer_torch.ops.warp_corr_train import (WarpCorrTrain, warp_corr_bwd,
                                                 warp_corr_bwd_plain)

from tests.test_warp import random_cameras
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

T = torch.from_numpy
G = 8


def setup(rng, B=1, V=1, H=48, W=128, D=4, C=8, jitter=True):
    """tests/test_pallas_warp.py's in-band geometry, V source views: ref
    [B,H,W,C], src [B,V,H,W,C], composed projections src [B,V,4,4] and ref
    [B,4,4], pixelwise depths [B,D,H,W] around 400-900."""
    ref = rng.standard_normal((B, H, W, C), dtype=np.float32)
    src = rng.standard_normal((B, V, H, W, C), dtype=np.float32)
    cams = [random_cameras(rng, B) for _ in range(V)]
    src_proj = np.stack([c[0] for c in cams], axis=1)
    ref_proj = cams[0][1]
    dv = np.broadcast_to(np.linspace(400, 900, D, dtype=np.float32)[None, :, None, None],
                         (B, D, H, W)).copy()
    if jitter:
        dv += rng.uniform(-2, 2, dv.shape).astype(np.float32)
    return ref, src, src_proj, ref_proj, dv


def xla_corr(ref, src_v, src_proj_v, ref_proj, dv):
    warped, invalid = jgeo.homo_warp(src_v, src_proj_v, ref_proj, dv)
    return jcorr.groupwise_correlation(ref, warped, G), invalid


# ------------------------------------------------------------------ K7

@pytest.mark.parametrize("B,V", [(1, 1), (2, 3)])
def test_warp_corr_fwd_plain_is_the_xla_path(rng, B, V):
    """K7's contract: per view the exact, unclipped XLA correlation, with
    zero padding where the warp leaves the source frustum, in K1's
    [B, V, G, D, H, W] layout."""
    ref, src, sp, rp, dv = setup(rng, B=B, V=V, H=20, W=36, D=5, C=16)
    corr = warp_corr_fwd(T(ref), T(src), T(sp), T(rp), T(dv), G)
    assert corr.shape == (B, V, G, 5, 20, 36) and corr.dtype == torch.float32
    for v in range(V):
        want, want_inv = xla_corr(jnp.asarray(ref), jnp.asarray(src[:, v]),
                                  jnp.asarray(sp[:, v]), jnp.asarray(rp), jnp.asarray(dv))
        # fp32 on both sides: the same products, coordinates ~1e2 equal to
        # their last bit or two.
        np.testing.assert_allclose(corr[:, v].permute(0, 2, 3, 4, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        assert 0 < np.asarray(want_inv).mean() < 1


@pytest.mark.parametrize("variant", ["v3", "v2", "v1"])
def test_warp_corr_fwd_plain_matches_pallas_interpret(rng, variant):
    """plane_sweep_group_corr_v3 (the training forward), _v2 and v1 agree
    with K7 wherever their TPU band does not clip, which is where they report
    no invalid pixel; the band may only add invalid pixels to the frustum
    mask of the XLA path."""
    ref, src, sp, rp, dv = setup(rng, B=2)
    fn, kw = {"v3": (jwarp.plane_sweep_group_corr_v3, dict(row_band=4)),
              "v2": (jwarp.plane_sweep_group_corr_v2, {}),
              "v1": (jwarp.plane_sweep_group_corr, {})}[variant]
    with pltpu.force_tpu_interpret_mode():
        want, want_inv = fn(jnp.asarray(ref), jnp.asarray(src[:, 0]), jnp.asarray(sp[:, 0]),
                            jnp.asarray(rp), jnp.asarray(dv), groups=G, band_rows=16,
                            band_cols=256, **kw)
    corr = warp_corr_fwd(T(ref), T(src), T(sp), T(rp), T(dv), G)
    got = corr[:, 0].permute(0, 2, 3, 4, 1).numpy()
    valid = ~np.asarray(want_inv)
    # The tolerance tests/test_pallas_warp.py holds these kernels to.
    np.testing.assert_allclose(got[valid], np.asarray(want)[valid], rtol=2e-4, atol=2e-4)
    xla_inv = xla_corr(jnp.asarray(ref), jnp.asarray(src[:, 0]), jnp.asarray(sp[:, 0]),
                       jnp.asarray(rp), jnp.asarray(dv))[1]
    assert (np.asarray(xla_inv) <= np.asarray(want_inv)).all()
    assert valid.mean() > 0.5


def test_training_entropy_is_jax_entropy_with_no_gradient(rng):
    """The training forward takes the visibility entropy of K7's output in
    torch ops: the JAX function's values, and no gradient back into the
    correlation (the JAX function stops it)."""
    corr = rng.standard_normal((2, 6, 5, 7, G)).astype(np.float32)
    got = entropy_over_depth(T(corr).requires_grad_())
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jcorr.entropy_over_depth(jnp.asarray(corr))),
                               rtol=1e-6, atol=1e-6)
    assert not got.requires_grad
    jgrad = jax.grad(lambda c: jcorr.entropy_over_depth(c).sum())(jnp.asarray(corr))
    assert not np.asarray(jgrad).any()


# ------------------------------------------------------------------ K8

@pytest.mark.parametrize("B,V,C", [(1, 1, 8), (2, 2, 16)])
def test_warp_corr_train_backward_matches_jax_vjp(rng, B, V, C):
    """WarpCorrTrain's CPU backward (K8's plain version) is jax.vjp of the
    XLA path in ref and src, summed over views for ref; projections and
    depths get no gradient."""
    ref, src, sp, rp, dv = setup(rng, B=B, V=V, H=24, W=40, D=3, C=C)
    tref, tsrc = T(ref).requires_grad_(), T(src).requires_grad_()
    tsp, trp, tdv = T(sp).requires_grad_(), T(rp), T(dv).requires_grad_()
    corr = WarpCorrTrain.apply(tref, tsrc, tsp, trp, tdv, G)
    dcorr = rng.standard_normal(tuple(corr.shape)).astype(np.float32)
    corr.backward(T(dcorr))
    assert tsp.grad is None and tdv.grad is None

    want_dref = np.zeros_like(ref)
    for v in range(V):
        _, vjp = jax.vjp(lambda r, s: xla_corr(r, s, jnp.asarray(sp[:, v]), jnp.asarray(rp),
                                               jnp.asarray(dv))[0],
                         jnp.asarray(ref), jnp.asarray(src[:, v]))
        dref, dsrc = vjp(jnp.asarray(dcorr[:, v].transpose(0, 2, 3, 4, 1)))
        want_dref += np.asarray(dref)
        # fp32 sums of the same products in another order: a dsrc entry
        # gathers up to 4*D scatter terms of scale ~1, a dref entry D.
        np.testing.assert_allclose(tsrc.grad[:, v].numpy(), np.asarray(dsrc),
                                   rtol=1e-5, atol=5e-5, err_msg=f"dsrc view {v}")
    np.testing.assert_allclose(tref.grad.numpy(), want_dref, rtol=1e-5, atol=5e-5)


def test_warp_corr_bwd_plain_matches_pallas_interpret(rng):
    """plane_sweep_group_corr_bwd in interpret mode, at the in-band geometry
    of tests/test_pallas_warp.py's test_bwd_kernel_batch2, with its
    tolerance."""
    ref, src, sp, rp, dv = setup(rng, B=2, H=24, W=128, D=3, jitter=False)
    dcorr = rng.standard_normal((2, 1, G, 3, 24, 128)).astype(np.float32)
    dref, dsrc = warp_corr_bwd(T(ref), T(src), T(sp), T(rp), T(dv), T(dcorr), G)
    with pltpu.force_tpu_interpret_mode():
        want_dref, want_dsrc = plane_sweep_group_corr_bwd(
            jnp.asarray(ref), jnp.asarray(src[:, 0]), jnp.asarray(sp[:, 0]), jnp.asarray(rp),
            jnp.asarray(dv), jnp.asarray(dcorr[:, 0].transpose(0, 2, 3, 4, 1)), groups=G,
            band_rows=16, band_cols=256)
    np.testing.assert_allclose(dref.numpy(), np.asarray(want_dref), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(dsrc[:, 0].numpy(), np.asarray(want_dsrc), rtol=1e-3, atol=1e-3)


def test_warp_corr_bwd_zoomed_matches_jax_vjp(rng):
    """Sources zoomed 3 times about the image centre, as chip_smoke.py's
    zoomed K8 check has them (neighbouring pixels' taps 3 source pixels
    apart): K8's plain version is the JAX custom_vjp's native_bwd=False
    backward (jax.vjp of the XLA path), summed over views for ref. Not the
    Pallas kernel, whose band clips there."""
    B, V, H, W, D = 2, 2, 24, 40, 3
    ref, src, sp, rp, dv = setup(rng, B=B, V=V, H=H, W=W, D=D, C=16)
    zoom = np.eye(4, dtype=np.float32)
    zoom[0, 0] = zoom[1, 1] = 3.0
    zoom[0, 2], zoom[1, 2] = -(W - 1), -(H - 1)
    sp = np.ascontiguousarray(zoom @ sp)
    dcorr = rng.standard_normal((B, V, G, D, H, W)).astype(np.float32)
    dref, dsrc = warp_corr_bwd(T(ref), T(src), T(sp), T(rp), T(dv), T(dcorr), G)
    want_dref = np.zeros_like(ref)
    for v in range(V):
        invalid = jgeo.homo_warp(jnp.asarray(src[:, v]), jnp.asarray(sp[:, v]),
                                 jnp.asarray(rp), jnp.asarray(dv))[1]
        assert 0.3 < np.asarray(invalid).mean() < 0.9  # the middle third lands in the source
        want = fused_warp_corr_train_bwd(
            G, 12, 1, False, tuple(jnp.asarray(a) for a in (ref, src[:, v], sp[:, v], rp, dv)),
            jnp.asarray(dcorr[:, v].transpose(0, 2, 3, 4, 1)))
        want_dref += np.asarray(want[0])
        # fp32 sums of the same products in another order, as above.
        np.testing.assert_allclose(dsrc[:, v].numpy(), np.asarray(want[1]), rtol=1e-5,
                                   atol=5e-5, err_msg=f"dsrc view {v}")
    np.testing.assert_allclose(dref.numpy(), want_dref, rtol=1e-5, atol=5e-5)


def test_warp_corr_bwd_cpu_wrapper_is_the_plain_version(rng):
    ref, src, sp, rp, dv = setup(rng, B=1, V=2, H=10, W=12, D=3)
    dcorr = T(rng.standard_normal((1, 2, G, 3, 10, 12)).astype(np.float32))
    args = (T(ref), T(src), T(sp), T(rp), T(dv), dcorr)
    torch.testing.assert_close(warp_corr_bwd(*args, G), warp_corr_bwd_plain(*args, G),
                               rtol=0, atol=0)


def test_warp_corr_train_gradcheck_float64(rng):
    """Finite differences in float64 at a tiny shape, where part of every
    view's warp falls outside the image."""
    ref, src, sp, rp, dv = setup(rng, B=1, V=2, H=5, W=7, D=2, C=8)
    for v in range(2):
        invalid = jgeo.homo_warp(jnp.asarray(src[:, v]), jnp.asarray(sp[:, v]),
                                 jnp.asarray(rp), jnp.asarray(dv))[1]
        assert 0 < np.asarray(invalid).mean() < 1
    ref64 = T(ref).double().requires_grad_()
    src64 = T(src).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda r, s: WarpCorrTrain.apply(r, s, T(sp), T(rp), T(dv), G), (ref64, src64),
        eps=1e-6, atol=1e-6, rtol=1e-5)
