"""The port's ops against the JAX package's, on the same numpy inputs (CPU).

Shapes follow tests/test_ops.py and tests/test_warp.py. Both sides are
fp32; tolerances allow for the two frameworks rounding in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.ops import correlation as jcorr
from mvsformer_tpu.ops import geometry as jgeo
from mvsformer_tpu.ops import hypotheses as jhyp
from mvsformer_tpu.ops import regression as jreg
from mvsformer_tpu.ops import resize as jres

from mvsformer_torch.ops import correlation, geometry, hypotheses, regression, resize, warp_corr

torch.set_num_threads(2)

T = torch.from_numpy


def random_cameras(rng, batch):
    """Shared K, small relative rotation/translation (tests/test_warp.py)."""
    K = np.array([[200.0, 0, 32.0], [0, 200.0, 24.0], [0, 0, 1]], np.float32)

    def make(angle, tx):
        c, s = np.cos(angle), np.sin(angle)
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        P[0, 3] = tx
        full = np.eye(4, dtype=np.float32)
        full[:3, :] = K @ P[:3, :]
        return full

    src = np.stack([make(rng.uniform(-0.05, 0.05), rng.uniform(-2, 2)) for _ in range(batch)])
    ref = np.stack([make(0.0, 0.0) for _ in range(batch)])
    return src, ref


# ------------------------------------------------------------ geometry

def test_compose_projection_matches_jax(rng):
    proj = rng.standard_normal((2, 3, 2, 4, 4)).astype(np.float32)
    got = geometry.compose_projection(T(proj)).numpy()
    want = np.asarray(jgeo.compose_projection(jnp.asarray(proj)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_pixel_depth", [False, True])
def test_homo_warp_matches_jax(rng, per_pixel_depth):
    B, C, H, W, D = 2, 8, 48, 64, 6
    src_fea = rng.standard_normal((B, H, W, C), dtype=np.float32)
    src_proj, ref_proj = random_cameras(rng, B)
    if per_pixel_depth:
        depth = np.broadcast_to(np.linspace(400, 900, D, dtype=np.float32)[None, :, None, None],
                                (B, D, H, W)).copy()
        depth += rng.uniform(-5, 5, size=depth.shape).astype(np.float32)
    else:
        depth = np.stack([np.linspace(400, 900, D, dtype=np.float32)] * B)
    got, got_mask = geometry.homo_warp(T(src_fea), T(src_proj), T(ref_proj), T(depth))
    want, want_mask = jgeo.homo_warp(jnp.asarray(src_fea), jnp.asarray(src_proj),
                                     jnp.asarray(ref_proj), jnp.asarray(depth))
    # Coordinates ~1e2 agree to fp32 rounding; bilinear output is continuous.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # The mask may differ only where a coordinate sits within rounding of a border.
    assert (got_mask.numpy() != np.asarray(want_mask)).mean() < 1e-3


@pytest.mark.parametrize("kind", ["zero_row", "repeated_row"])
def test_singular_reference_camera_is_non_finite_as_in_jax(kind):
    """A singular reference projection does not raise: the relative
    projection, as the plain version and the warp wrappers' `relative_rows`
    take it, is non-finite exactly where jnp.linalg.inv makes JAX's so."""
    K = np.array([[200.0, 0, 32.0, 0], [0, 200.0, 24.0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                 np.float32)
    ref = K.copy()
    if kind == "zero_row":
        ref[2] = 0.0
    else:
        ref[2] = ref[0]
    src, _ = random_cameras(np.random.default_rng(3), 1)
    H, W = 6, 8
    depth = np.linspace(400, 900, 3, dtype=np.float32)[None]
    want_rel = np.asarray(jnp.matmul(jnp.asarray(src), jnp.linalg.inv(jnp.asarray(ref[None])),
                                     precision=jax.lax.Precision.HIGHEST))
    got_rel = warp_corr.relative_rows(T(src)[:, None], T(ref[None]))[:, 0].numpy()
    assert not np.isfinite(want_rel[:, :3]).all()
    np.testing.assert_array_equal(np.isfinite(got_rel), np.isfinite(want_rel[:, :3]))
    got = geometry.plane_sweep_coords(T(src), T(ref[None]), T(depth), H, W)
    want = jgeo.plane_sweep_coords(jnp.asarray(src), jnp.asarray(ref[None]), jnp.asarray(depth),
                                   H, W)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(np.asarray(w)))
        np.testing.assert_allclose(g.numpy()[np.isfinite(g.numpy())],
                                   np.asarray(w)[np.isfinite(np.asarray(w))], rtol=1e-5)


def test_bilinear_sample_matches_jax(rng):
    B, H, W, C = 2, 20, 30, 4
    src = rng.standard_normal((B, H, W, C), dtype=np.float32)
    px = rng.uniform(-4, W + 3, size=(B, 500)).astype(np.float32)
    py = rng.uniform(-4, H + 3, size=(B, 500)).astype(np.float32)
    got = geometry.bilinear_sample(T(src), T(px), T(py)).numpy()
    want = np.asarray(jgeo.bilinear_sample(jnp.asarray(src), jnp.asarray(px), jnp.asarray(py)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- correlation

def test_groupwise_correlation_and_entropy_match_jax(rng):
    B, D, H, W, C, G = 2, 6, 5, 7, 16, 8
    ref = rng.standard_normal((B, H, W, C), dtype=np.float32)
    warped = rng.standard_normal((B, D, H, W, C), dtype=np.float32)
    got = correlation.groupwise_correlation(T(ref), T(warped), G)
    want = jcorr.groupwise_correlation(jnp.asarray(ref), jnp.asarray(warped), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    got_e = correlation.entropy_over_depth(got).numpy()
    want_e = np.asarray(jcorr.entropy_over_depth(want))
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- hypotheses

def test_init_ranges_match_jax(rng):
    B, D, H, W = 2, 8, 6, 7
    dv = np.sort(rng.uniform(400, 900, (B, 64)).astype(np.float32), axis=1)
    for port, ref in ((hypotheses.init_inverse_range, jhyp.init_inverse_range),
                      (hypotheses.init_range, jhyp.init_range)):
        np.testing.assert_allclose(port(T(dv), D, H, W).numpy(),
                                   np.asarray(ref(jnp.asarray(dv), D, H, W)), rtol=1e-5)


def test_schedule_inverse_range_matches_jax(rng):
    B, Dprev, h, w, D = 2, 8, 6, 8, 4
    depth = rng.uniform(450, 850, (B, h, w)).astype(np.float32)
    base = np.linspace(400, 900, Dprev, dtype=np.float32)[::-1]
    hypo = np.broadcast_to(base[None, :, None, None], (B, Dprev, h, w)).copy()
    got = hypotheses.schedule_inverse_range(T(depth), T(hypo), D, 1.5, 2 * h, 2 * w)
    want = jhyp.schedule_inverse_range(jnp.asarray(depth), jnp.asarray(hypo), D, 1.5,
                                       2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_schedule_range_matches_jax(rng):
    B, h, w, D = 2, 6, 8, 8
    depth = rng.uniform(430, 880, (B, h, w)).astype(np.float32)
    itv = rng.uniform(2, 4, (B,)).astype(np.float32)
    got = hypotheses.schedule_range(T(depth), D, T(itv), 2 * h, 2 * w)
    want = jhyp.schedule_range(jnp.asarray(depth), D, jnp.asarray(itv), 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------- regression

def test_depth_regression_matches_jax(rng):
    B, D, H, W = 2, 16, 6, 8
    prob = np.array(jax.nn.softmax(jnp.asarray(rng.standard_normal((B, D, H, W)),
                                                 jnp.float32), axis=1))
    dv = np.sort(rng.uniform(400, 900, (B, D)).astype(np.float32), axis=1)
    got = regression.depth_regression(T(prob), T(dv)).numpy()
    want = np.asarray(jreg.depth_regression(jnp.asarray(prob), jnp.asarray(dv)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("tmp", [5.0, 1.0])
def test_decode_depth_eval_ce_matches_jax(rng, tmp):
    B, D, H, W = 2, 8, 5, 6
    logits = (rng.standard_normal((B, D, H, W)) * 3).astype(np.float32)
    dv = np.sort(rng.uniform(400, 900, (B, D, H, W)).astype(np.float32), axis=1)
    got_d, got_c = regression.decode_depth(T(logits), T(dv), "ce", tmp)
    jl = jnp.asarray(logits)
    want_d, want_c = jreg.decode_depth(jl, jax.nn.softmax(jl, axis=1), jnp.asarray(dv),
                                       "ce", D, False, tmp)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------- resize

@pytest.mark.parametrize("align_corners", [True, False])
def test_resize_bilinear_matches_jax(rng, align_corners):
    x = rng.standard_normal((2, 5, 12, 16), dtype=np.float32)
    got = resize.resize_bilinear(T(x), (24, 32), align_corners=align_corners).numpy()
    want = np.asarray(jres.resize_bilinear(jnp.asarray(x), (24, 32), spatial_axes=(2, 3),
                                           align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_nearest_matches_jax(rng):
    x = rng.standard_normal((2, 10, 14), dtype=np.float32)
    got = resize.resize_nearest(T(x), (20, 28)).numpy()
    want = np.asarray(jres.resize_nearest(jnp.asarray(x), (20, 28), spatial_axes=(1, 2)))
    np.testing.assert_array_equal(got, want)


def test_resize_bicubic_matches_jax(rng):
    x = rng.standard_normal((2, 3, 24, 32), dtype=np.float32)
    got = resize.resize_bicubic(T(x), (12, 16)).numpy()
    want = np.asarray(jres.resize_bicubic(jnp.asarray(x), (12, 16), spatial_axes=(2, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=4e-6)
