"""The port's fusion (`mvsformer_torch/ops/fusion.py`, `fuse.py`) and file
codecs (PFM, cam files, PLY) against the JAX package's, on the CPU.

The scenes are tests/test_fusion.py's: a fronto-parallel plane seen by a
reference camera and four sources shifted along x, with exact depths
(:39, :88), one source corrupted (:58), every source inconsistent (:77),
per-pixel noise (:145) and a +100 depth error (:226). Every function of
the JAX module runs on each case; masks must be equal, and depths, pixel
coordinates and points within 1e-5 relative (the port broadcasts over the
source views and writes its small matrix products as multiply-adds, the
JAX package vmaps and calls einsum: the same fp32 sums in another order).

`fuse_scan` runs on a scan written here (combined and stacked confidence,
as :111 and :173) by both packages, which must keep the same points:
the same count, coordinates within 1e-4 and equal colours.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mvsformer_tpu import fuse as jax_fuse
from mvsformer_tpu.ops import fusion as JF
from mvsformer_tpu.utils import cams as jax_cams
from mvsformer_tpu.utils import pfm as jax_pfm
from mvsformer_tpu.utils import ply as jax_ply
from mvsformer_torch import fuse as port_fuse
from mvsformer_torch.ops import fusion as TF
from mvsformer_torch.utils import cams as port_cams
from mvsformer_torch.utils import pfm as port_pfm
from mvsformer_torch.utils import ply as port_ply
from mvsformer_torch.utils.image import read_image, write_png
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

H, W = 48, 64
DEPTH = 500.0
K = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]], np.float32)
RTOL = 1e-5
FUSE_SCAN_ATOL = 1e-4


def cam(tx):
    ext = np.eye(4, dtype=np.float32)
    ext[0, 3] = tx
    c = np.zeros((2, 4, 4), np.float32)
    c[0] = ext
    c[1, :3, :3] = K
    c[1, 3, 3] = 1
    return c


def scene(case):
    """(ref_depth [1,H,W], src_depths [1,4,H,W], ref_cam, src_cams, conf)."""
    ref_depth = np.full((H, W), DEPTH, np.float32)
    src_depths = np.full((4, H, W), DEPTH, np.float32)
    if case == "src0_corrupt":
        src_depths[0] = DEPTH * 1.5
    elif case == "inconsistent":
        src_depths[:] = DEPTH * 1.5
    elif case == "noisy":
        src_depths = src_depths + np.random.default_rng(0).normal(
            0.0, 2.0, src_depths.shape).astype(np.float32)
    elif case == "plus100":
        src_depths = src_depths + 100.0
    conf = np.ones((1, H, W), np.float32)
    if case == "stacked_conf":
        conf = np.ones((1, 4, H, W), np.float32)
        conf[0, 1, :, : W // 2] = 0.1
    src_cams = np.stack([cam((i + 1) * 5.0) for i in range(4)])
    return (ref_depth[None], src_depths[None], cam(0.0)[None], src_cams[None], conf)


CASES = ["plane", "src0_corrupt", "inconsistent", "noisy", "plus100", "stacked_conf"]


def assert_close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def assert_all_close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("case", CASES)
def test_back_project_and_project(case):
    ref_depth, src_depths, ref_cam, src_cams, _ = scene(case)
    jw = JF.back_project(jnp.asarray(ref_depth), jnp.asarray(ref_cam))
    tw = TF.back_project(torch.from_numpy(ref_depth), torch.from_numpy(ref_cam))
    assert_close(tw, jw)
    for v in range(src_cams.shape[1]):
        jxy, jz = JF.project(jw, jnp.asarray(src_cams[:, v]))
        txy, tz = TF.project(torch.tensor(np.asarray(jw)), torch.from_numpy(src_cams[:, v]))
        assert_close(txy, jxy)
        assert_close(tz, jz)
        jb = JF.back_project_at(jxy, jnp.asarray(src_depths[:, v]), jnp.asarray(src_cams[:, v]))
        tb = TF.back_project_at(torch.tensor(np.asarray(jxy)), torch.from_numpy(src_depths[:, v]),
                                torch.from_numpy(src_cams[:, v]))
        assert_close(tb, jb)


@pytest.mark.parametrize("case", CASES)
def test_reproject_one_view_and_all_views(case):
    ref_depth, src_depths, ref_cam, src_cams, _ = scene(case)
    jall = JF.reproject_all(*[jnp.asarray(a) for a in (ref_depth, src_depths, ref_cam, src_cams)])
    tall = TF.reproject_all(*[torch.from_numpy(a) for a in (ref_depth, src_depths, ref_cam,
                                                             src_cams)])
    assert_all_close(tall, jall)
    for v in range(src_depths.shape[1]):
        one = TF.reproject(*[torch.from_numpy(np.ascontiguousarray(a)) for a in (
            ref_depth, src_depths[:, v], ref_cam, src_cams[:, v])])
        assert_all_close(one, JF.reproject(*[jnp.asarray(a) for a in (
            ref_depth, src_depths[:, v], ref_cam, src_cams[:, v])]))
        assert_all_close(one, (tall[0][:, v], tall[1][:, v]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("thresholds", [(1.0, 0.01, 5), (0.25, 0.01, 4), (1.0, 0.01, 3)],
                         ids=["default", "strict", "gipuma_mapped"])
def test_vis_filter_and_ave_fusion(case, thresholds):
    ref_depth, src_depths, ref_cam, src_cams, _ = scene(case)
    xy, d = (np.array(a) for a in JF.reproject_all(
        *[jnp.asarray(a) for a in (ref_depth, src_depths, ref_cam, src_cams)]))
    jm = JF.vis_filter(jnp.asarray(ref_depth), jnp.asarray(xy), jnp.asarray(d), *thresholds)
    tm = TF.vis_filter(torch.from_numpy(ref_depth), torch.from_numpy(xy), torch.from_numpy(d),
                       *thresholds)
    assert_all_close(tm, jm)
    assert_close(TF.ave_fusion(torch.from_numpy(ref_depth), torch.from_numpy(d), tm[0]),
                 JF.ave_fusion(jnp.asarray(ref_depth), jnp.asarray(d), jm[0]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bases", [(4.0, 1300.0), (1.0, 100.0)], ids=["default", "loose"])
def test_vis_filter_dynamic(case, bases):
    ref_depth, src_depths, ref_cam, src_cams, _ = scene(case)
    xy, d = (np.array(a) for a in JF.reproject_all(
        *[jnp.asarray(a) for a in (ref_depth, src_depths, ref_cam, src_cams)]))
    jm = JF.vis_filter_dynamic(jnp.asarray(ref_depth), jnp.asarray(xy), jnp.asarray(d), *bases)
    tm = TF.vis_filter_dynamic(torch.from_numpy(ref_depth), torch.from_numpy(xy),
                               torch.from_numpy(d), *bases)
    assert_all_close(tm, jm)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("want_reproj_depth", [False, True])
@pytest.mark.parametrize("disp", [(0.1, 2), (0.5, 2), (0.5, 3)])
def test_vis_filter_disparity(case, want_reproj_depth, disp):
    args = scene(case)[:4]
    j = JF.vis_filter_disparity(*[jnp.asarray(a) for a in args], *disp,
                                want_reproj_depth=want_reproj_depth)
    t = TF.vis_filter_disparity(*[torch.from_numpy(a) for a in args], *disp,
                                want_reproj_depth=want_reproj_depth)
    assert_all_close(t, j)


FUSE = {
    "pcd": [dict(thres_view=3), dict(dist_thresh=0.25, thres_view=4), dict()],
    "dpcd": [dict(), dict(dist_base=1.0, rel_diff_base=100.0)],
    "gipuma": [dict(disp_thresh=0.1, num_consistent=3), dict(disp_thresh=0.5, num_consistent=2),
               dict(disp_thresh=0.5, num_consistent=3)],
}


UNSTABLE_EPS = 1e-6     # a relative change of the source depths far below fp32 data's precision
UNSTABLE_SHARE = 1e-3   # of the pixels, at most


def unstable_pixels(fn, args, *extra, **kw):
    """Pixels whose JAX mask changes when the source depths move by 1e-6 of
    their value: there a decision quantity lies within a few ulps of its
    threshold, and the last bits of the reprojection (summed in another order
    by the port) decide it."""
    masks = [np.asarray(fn(args[0], args[1] * (1 + s * UNSTABLE_EPS), *args[2:], *extra,
                           **kw)[0]) for s in (-1, 1)]
    return masks[0] != masks[1]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method,kw", [(m, kw) for m, kws in FUSE.items() for kw in kws],
                         ids=[f"{m}{i}" for m, kws in FUSE.items() for i in range(len(kws))])
def test_fuse_one_view(case, method, kw):
    """Masks equal at every pixel whose decision is not within a few ulps of
    its threshold (the noisy case has such pixels: one at
    dpcd0-noisy, its relative depth difference 2e-8 from 4/1300), fused
    depths and points within 1e-5 relative there."""
    prob = (0.5, 0.5, 0.5, 0.5) if case == "stacked_conf" else (0.5,)
    args = scene(case)
    jfn = getattr(JF, f"fuse_{method}")
    j = jfn(*[jnp.asarray(a) for a in args], prob, **kw)
    t = getattr(TF, f"fuse_{method}")(*[torch.from_numpy(a) for a in args], prob, **kw)
    unstable = unstable_pixels(jfn, [jnp.asarray(a) for a in args], prob, **kw)
    assert unstable.mean() <= UNSTABLE_SHARE, unstable.mean()
    stable = ~unstable
    np.testing.assert_array_equal(t[0].numpy()[stable], np.asarray(j[0])[stable])
    assert_close(t[1].numpy()[stable], np.asarray(j[1])[stable])
    assert_close(t[2].numpy()[stable], np.asarray(j[2])[stable])
    if case != "noisy":
        assert not unstable.any()
    if case == "plane":  # the exact scene keeps the interior (tests/test_fusion.py)
        assert t[0][0, 8:-8, 16:-16].all()


# ---- fuse_scan on a scan folder --------------------------------------------

N_VIEWS = 5


def write_scan(root, stacked):
    """Phase-1 artifacts of the plane, seen by 5 cameras 5 apart: source 1's
    depth is off by 30% in a block, the confidence low in a band (or, stacked,
    stage 2 low on the left half), and each image a colour ramp (PNG bytes
    under .jpg, as the port writes them)."""
    scan = os.path.join(root, "scan1")
    for sub in ("depth_est", "confidence", "cams", "images"):
        os.makedirs(os.path.join(scan, sub), exist_ok=True)
    with open(os.path.join(scan, "pair.txt"), "w") as f:
        f.write(f"{N_VIEWS}\n")
        for ref in range(N_VIEWS):
            srcs = [v for v in range(N_VIEWS) if v != ref]
            f.write(f"{ref}\n{len(srcs)} " + " ".join(
                f"{s} {10 - i}" for i, s in enumerate(srcs)) + "\n")
    y, x = np.mgrid[0:H, 0:W]
    for vid in range(N_VIEWS):
        depth = np.full((H, W), DEPTH, np.float32)
        if vid == 1:
            depth[10:30, 20:40] *= 1.3
        port_pfm.save_pfm(os.path.join(scan, "depth_est", f"{vid:0>8}.pfm"), depth)
        if stacked:
            conf = np.ones((4, H, W), np.float32)
            conf[1, :, : W // 2] = 0.1
        else:
            conf = np.ones((H, W), np.float32)
            conf[:, 5 + vid:9 + vid] = 0.2
        np.save(os.path.join(scan, "confidence", f"{vid:0>8}.npy"), conf)
        c = cam(vid * 5.0)
        port_cams.write_cam_file(os.path.join(scan, "cams", f"{vid:0>8}_cam.txt"),
                                 port_cams.CameraParams(c[0], c[1, :3, :3], 400.0, 2.5))
        img = np.stack([x * 4 % 256, y * 5 % 256, (x + y + 40 * vid) % 256], -1).astype(np.uint8)
        write_png(os.path.join(scan, "images", f"{vid:0>8}.jpg"), img)
    return scan


@pytest.mark.parametrize("stacked", [False, True], ids=["combined", "stacked"])
@pytest.mark.parametrize("method", ["pcd", "dpcd", "gipuma"])
def test_fuse_scan_matches_jax(tmp_path, stacked, method):
    scan = write_scan(str(tmp_path), stacked)
    prob = (0.5, 0.5, 0.5, 0.5) if stacked else (0.5,)
    kw = dict(method=method, prob_threshold=prob, thres_view=3, n_src_views=4,
              logger=lambda *a: None)
    n_jax = jax_fuse.fuse_scan(scan, scan, str(tmp_path / "jax.ply"), **kw)
    n_port = port_fuse.fuse_scan(scan, scan, str(tmp_path / "port.ply"), device="cpu", **kw)
    assert n_port == n_jax and n_port > 1000, (n_port, n_jax)
    jp, jc = jax_ply.read_ply(str(tmp_path / "jax.ply"))
    tp, tc = port_ply.read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=FUSE_SCAN_ATOL * DEPTH)
    np.testing.assert_array_equal(tc, jc)
    if method != "gipuma":
        # gipuma's disparity check also keeps a few depths that the bilinear
        # sample blends across the edge of source 1's off block, in both
        # packages; the static and dynamic checks keep only the plane.
        np.testing.assert_allclose(tp[:, 2], DEPTH, rtol=1e-3)


def test_fusion_dataset_matches_jax(tmp_path):
    scan = write_scan(str(tmp_path), stacked=False)
    jds, tds = jax_fuse.FusionDataset(scan, scan, 3), port_fuse.FusionDataset(scan, scan, 3)
    assert len(jds) == len(tds) == N_VIEWS
    for i in range(N_VIEWS):
        j, t = jds[i], tds[i]
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]), err_msg=k)


def test_fuse_scan_refuses_an_unknown_method(tmp_path):
    scan = write_scan(str(tmp_path), stacked=False)
    with pytest.raises(ValueError, match="unknown fusion method"):
        port_fuse.fuse_scan(scan, scan, str(tmp_path / "x.ply"), method="fusibile", device="cpu")


# ---- file codecs, both ways ------------------------------------------------

WRITERS = {"jax": (jax_pfm, jax_cams, jax_ply), "port": (port_pfm, port_cams, port_ply)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("shape", [(17, 23), (17, 23, 3)])
def test_pfm_round_trip(tmp_path, writer, reader, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 300
    p = str(tmp_path / "x.pfm")
    WRITERS[writer][0].save_pfm(p, x, scale=2.0)
    got, scale = WRITERS[reader][0].read_pfm(p)
    np.testing.assert_array_equal(got, x)
    assert scale == 2.0
    with open(p, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "y.pfm")
    WRITERS[reader][0].save_pfm(other, x, scale=2.0)
    with open(other, "rb") as f:
        assert f.read() == raw


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("tail", [(), (192.0,), (192.0, 905.0)], ids=["2", "3", "4"])
def test_cam_file_round_trip(tmp_path, writer, reader, tail):
    rng = np.random.default_rng(1)
    ext = rng.standard_normal((4, 4)).astype(np.float32)
    intr = rng.standard_normal((3, 3)).astype(np.float32) * 100
    wmod, rmod = WRITERS[writer][1], WRITERS[reader][1]
    p = str(tmp_path / "c.txt")
    wmod.write_cam_file(p, wmod.CameraParams(ext, intr, 425.0, 2.5, *tail))
    got, want = rmod.read_cam_file(p, 1.06), WRITERS[writer][1].read_cam_file(p, 1.06)
    for k in ("extrinsic", "intrinsic"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("depth_min", "depth_interval", "num_depth", "depth_max"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.stacked(), want.stacked())
    q = str(tmp_path / "d.txt")
    rmod.write_cam_file(q, rmod.CameraParams(ext, intr, 425.0, 2.5, *tail))
    with open(p) as a, open(q) as b:
        assert a.read() == b.read()


def test_pair_file_matches_jax(tmp_path):
    scan = write_scan(str(tmp_path), stacked=False)
    p = os.path.join(scan, "pair.txt")
    assert port_cams.read_pair_file(p) == jax_cams.read_pair_file(p)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_round_trip(tmp_path, writer, reader, with_colors):
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (100, 3), dtype=np.uint8) if with_colors else None
    p = str(tmp_path / "x.ply")
    WRITERS[writer][2].write_ply(p, pts, cols)
    got_p, got_c = WRITERS[reader][2].read_ply(p)
    np.testing.assert_array_equal(got_p, pts)
    if with_colors:
        np.testing.assert_array_equal(got_c, cols)
    else:
        assert got_c is None
    q = str(tmp_path / "y.ply")
    WRITERS[reader][2].write_ply(q, pts, cols)
    with open(p, "rb") as a, open(q, "rb") as b:
        assert a.read() == b.read()


def test_fusion_images_read_back_as_written(tmp_path):
    scan = write_scan(str(tmp_path), stacked=False)
    img = read_image(os.path.join(scan, "images", "00000002.jpg"))
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
