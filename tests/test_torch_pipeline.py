"""The port's two-phase test pipeline against the JAX package's, on the CPU.

One synthetic DTU-layout tree, written here with the port's writers:
scan1 with 4 views (PNG bytes under images/*.jpg, DTU-layout cams,
Depths_raw ground truth of a tilted plane at 80x80), scan2 with cams_1 and
a view with a single source (padded), a T&T short-range camera folder. One `.pth` holds the JAX init (randomised BN) through the weight
bridge, with DataParallel's `module.` prefix; each package loads it with its
own `load_reference_checkpoint`. The model is tests/test_torch_model.py's:
64x64, 3 views, ndepths 8/4/4/2 over 48 depths, full-width alt_gvt_small.

- `MVSEvalDataset` (dtu, tt, short range, iterative, cams_1 and padding):
  every array equal to the JAX dataset's, but the images, which go through
  the bilinear resize at 64x64 -> 48x56 within one grey level of OpenCV's
  (tests/test_torch_image.py), that is 1 / 255 / min(std) after
  normalisation; at equal sizes they are equal.
- `save_depth`, images at the model's size (the resize is the identity on
  both sides): depth within 1e-2, confidence within 1e-4 (the model test's
  bounds), the cams' numbers equal, the PNG the JAX image before its JPEG
  encoding, and depth_metric.txt within 1e-4.
- JAX `fuse_scan` on the port's output folder against the port's: the same
  number of points, coordinates within 1e-4 relative, colours equal.
- `python -m mvsformer_torch.test` through `main(argv)` on the CPU, to a PLY.
"""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu import fuse as jax_fuse
from mvsformer_tpu import infer as jax_infer
from mvsformer_tpu.config import Config as JaxConfig
from mvsformer_tpu.config import ModelConfig as JaxModelConfig
from mvsformer_tpu.config import save_config as jax_save_config
from mvsformer_tpu.data import eval_dataset as jax_eval
from mvsformer_tpu.data.augment import IMAGENET_MEAN as JAX_MEAN
from mvsformer_tpu.data.augment import IMAGENET_STD as JAX_STD
from mvsformer_tpu.data.loader import collate as jax_collate
from mvsformer_tpu.models.mvsformer import build_model as jax_build_model
from mvsformer_tpu.utils import metrics as jax_metrics
from mvsformer_tpu.utils.convert_weights import load_reference_checkpoint as jax_load_ckpt
from mvsformer_torch import fuse as port_fuse
from mvsformer_torch import infer as port_infer
from mvsformer_torch import test as port_cli
from mvsformer_torch.config import ModelConfig
from mvsformer_torch.data import eval_dataset as port_eval
from mvsformer_torch.data.augment import IMAGENET_STD
from mvsformer_torch.data.loader import collate, eval_loader
from mvsformer_torch.models.mvsformer import build_model
from mvsformer_torch.utils import metrics as port_metrics
from mvsformer_torch.utils.cams import CameraParams, read_cam_file, write_cam_file
from mvsformer_torch.utils.convert_weights import convert_flax_twin, load_reference_checkpoint
from mvsformer_torch.utils.image import read_image, write_png
from mvsformer_torch.utils.pfm import read_pfm, save_pfm
from mvsformer_torch.utils.ply import read_ply

from test_torch_model import CFG, TMPS, make_batch, randomise_bn, to_numpy
from test_torch_watchdog import watchdog

torch.set_num_threads(2)
hang_watchdog = watchdog()

NV, SIZE, GT_SIZE, NDEPTHS, NUM_VIEW = 4, 64, 80, 48, 3
DEPTH_ATOL, CONF_ATOL, METRIC_ATOL = 1e-2, 1e-4, 1e-4
IMG_ATOL = 1.0 / 255.0 / float(IMAGENET_STD.min()) + 1e-6  # one grey level, normalised
FUSE_ATOL = 1e-4
JAX_CFG = dict(CFG, fused_enc_head=False, fused_fpn_final=False, fused_fpn_l2=False)


def write_pairs(path, pairs):
    with open(path, "w") as f:
        f.write(f"{len(pairs)}\n")
        for ref, srcs in pairs:
            f.write(f"{ref}\n{len(srcs)} " + " ".join(f"{s} {10 - i}" for i, s in enumerate(srcs))
                    + "\n")


def file_cam(vid, scale=1.0):
    """A DTU-layout camera: intrinsics at the image's size (the dataset
    quarters them for stage 2), views 2 apart in x, 425 + 2.5 x 192 depths."""
    K = np.array([[80.0, 0, 32.0], [0, 80.0, 30.0], [0, 0, 1]], np.float32)
    ext = np.eye(4, dtype=np.float32)
    ext[0, 3] = vid * 2.0 * scale
    return CameraParams(ext, K, 425.0, 2.5, 192.0)


def write_tree(root, img_size=SIZE):
    """The synthetic tree; returns the dataset root (root/dtu)."""
    rng = np.random.default_rng(0)
    data = os.path.join(root, "dtu")
    y, x = np.mgrid[0:img_size, 0:img_size]
    for scan, cam_dir, pairs in (
            ("scan1", "cams", [(r, [v for v in range(NV) if v != r]) for r in range(NV)]),
            ("scan2", "cams_1", [(0, [1]), (1, [0, 2]), (2, []), (3, [2, 1, 0])])):
        for sub in ("images", cam_dir):
            os.makedirs(os.path.join(data, scan, sub), exist_ok=True)
        write_pairs(os.path.join(data, scan, "pair.txt"), pairs)
        for v in range(NV):
            ramp = np.stack([x * 3 + 7 * v, y * 4, x + y], -1) % 256
            noise = rng.integers(0, 256, (img_size, img_size, 3))
            img = np.where(rng.random((img_size, img_size, 1)) < 0.3, noise, ramp)
            write_png(os.path.join(data, scan, "images", f"{v:0>8}.jpg"), img.astype(np.uint8))
            write_cam_file(os.path.join(data, scan, cam_dir, f"{v:0>8}_cam.txt"), file_cam(v))
    short = os.path.join(data, "short_range_cameras", "cams_scan1")
    os.makedirs(short, exist_ok=True)
    for v in range(NV):
        write_cam_file(os.path.join(short, f"{v:0>8}_cam.txt"), file_cam(v, scale=0.5))
    gt = os.path.join(root, "Depths_raw", "scan1")
    os.makedirs(gt, exist_ok=True)
    gy, gx = np.mgrid[0:GT_SIZE, 0:GT_SIZE]
    for v in range(NV):
        save_pfm(os.path.join(gt, f"depth_map_{v:0>4}.pfm"),
                 (600.0 + 2.0 * gx + 1.5 * gy + 10 * v).astype(np.float32))
        mask = np.where((gx > 8) & (gy > 5 + v), 255, 3).astype(np.uint8)
        write_png(os.path.join(gt, f"depth_visual_{v:0>4}.png"), mask)
    return data


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    return dict(root=str(root), data=write_tree(str(root)))


# ---- the dataset -----------------------------------------------------------

DATASETS = {
    "dtu": dict(dataset="dtu"),
    "dtu_resized": dict(dataset="dtu", max_h=48, max_w=56),
    "dtu_cams_1_padding": dict(dataset="dtu", scans=["scan1", "scan2"],
                               interval_scale={"scan1": 1.06, "scan2": 0.8}),
    "dtu_iterative_no_refine": dict(dataset="dtu", iterative=True, refine=False),
    "tt": dict(dataset="tt", max_h=48, max_w=56),
    "tt_short_range": dict(dataset="tt", use_short_range=True),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_eval_dataset_matches_jax(tree, name):
    kw = dict(DATASETS[name])
    scans = kw.pop("scans", ["scan1"])
    kw = dict(dict(nviews=NUM_VIEW, ndepths=NDEPTHS, interval_scale=1.06, max_h=SIZE,
                   max_w=SIZE), **kw)
    jds = jax_eval.MVSEvalDataset(tree["data"], scans, **kw)
    tds = port_eval.MVSEvalDataset(tree["data"], scans, **kw)
    assert jds.metas == tds.metas and len(tds) > 0
    resized = (kw["max_h"], kw["max_w"]) != (SIZE, SIZE) or kw["dataset"] == "tt"
    for i in range(len(tds)):
        j, t = jds[i], tds[i]
        assert j.keys() == t.keys()
        assert t["filename"] == j["filename"]
        assert j["proj_matrices"].keys() == t["proj_matrices"].keys()
        for k in j["proj_matrices"]:
            np.testing.assert_array_equal(t["proj_matrices"][k], j["proj_matrices"][k], err_msg=k)
        np.testing.assert_array_equal(t["depth_values"], j["depth_values"])
        for k in ("depth_gt", "mask"):
            if k in j:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["imgs"].dtype == np.float32 and t["imgs"].shape == j["imgs"].shape
        if resized:
            np.testing.assert_allclose(t["imgs"], j["imgs"], rtol=0, atol=IMG_ATOL)
        else:
            np.testing.assert_array_equal(t["imgs"], j["imgs"])
    if name == "dtu":
        assert "depth_gt" in tds[0] and tds[0]["mask"].any() and not tds[0]["mask"].all()
    batch, jbatch = collate([tds[0], tds[1]]), jax_collate([jds[0], jds[1]])
    assert batch["filename"] == jbatch["filename"]
    np.testing.assert_array_equal(batch["proj_matrices"]["stage2"], jbatch["proj_matrices"]["stage2"])
    loaded = next(iter(eval_loader(tds, batch_size=2)))
    assert loaded["filename"] == batch["filename"]
    np.testing.assert_array_equal(loaded["imgs"], batch["imgs"])


def test_eval_dataset_refuses_jpeg_naming_the_roadmap_item(tmp_path):
    data = write_tree(str(tmp_path))
    cv2.imwrite(os.path.join(data, "scan1", "images", "00000001.jpg"),
                np.zeros((SIZE, SIZE, 3), np.uint8))
    ds = port_eval.MVSEvalDataset(data, ["scan1"], nviews=NUM_VIEW, ndepths=NDEPTHS,
                                  max_h=SIZE, max_w=SIZE)
    with pytest.raises(ValueError, match="JPEG.*ROADMAP A3"):
        ds[0]


# ---- metrics ---------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    est = rng.uniform(400, 900, (2, 16, 20)).astype(np.float32)
    gt = (est + rng.normal(0, 10, est.shape)).astype(np.float32)
    mask = rng.random(est.shape) > 0.3
    for name in ("depth_metrics", "validation_metrics"):
        j = getattr(jax_metrics, name)(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask), 4.0)
        t = getattr(port_metrics, name)(torch.from_numpy(est), torch.from_numpy(gt),
                                        torch.from_numpy(mask), 4.0)
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        float(port_metrics.thres_metric(torch.from_numpy(est), torch.from_numpy(gt),
                                        torch.from_numpy(mask), 8.0)),
        float(jax_metrics.thres_metric(jnp.asarray(est), jnp.asarray(gt), jnp.asarray(mask),
                                       8.0)), rtol=1e-6)


# ---- save_depth, fusion and the CLI ------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tree):
    """A reference-layout .pth of the JAX init (BN randomised), and the run
    dir the CLI reads config.json from."""
    imgs, projs, dv = make_batch(np.random.default_rng(0))
    jmodel = jax_build_model(JaxModelConfig(**JAX_CFG), dtype=jnp.float32)
    variables = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(imgs), jax.tree.map(jnp.asarray, projs), jnp.asarray(dv),
        training=False))(jax.random.PRNGKey(0))
    params, stats = to_numpy(variables["params"]), to_numpy(variables["batch_stats"])
    randomise_bn(params, stats, np.random.default_rng(1))
    sd = convert_flax_twin(params, stats, tuple(CFG["ndepths"]))
    run = os.path.join(tree["root"], "run")
    os.makedirs(run, exist_ok=True)
    path = os.path.join(run, "model.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    cfg = JaxConfig()
    cfg.arch = JaxModelConfig(**JAX_CFG)
    jax_save_config(cfg, os.path.join(run, "config.json"))
    return dict(path=path, run=run, jmodel=jmodel)


SAVE_KW = dict(num_view=NUM_VIEW, ndepths=NDEPTHS, interval_scale=1.06, max_h=SIZE, max_w=SIZE,
               tmps=TMPS)


@pytest.fixture(scope="module")
def saved(tree, ckpt):
    """save_depth of both packages on scan1, stacked per-stage confidences
    (one JAX forward compile); the port's run also with combined ones."""
    params, stats = jax_load_ckpt(ckpt["path"], ndepths=tuple(CFG["ndepths"]), model_th=8)
    out_jax = os.path.join(tree["root"], "out_jax")
    jmetrics = jax_infer.save_depth(
        ckpt["jmodel"], jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        ["scan1"], tree["data"], out_jax, combine_conf=False, logger=lambda *a: None,
        **SAVE_KW)
    model = build_model(ModelConfig(**CFG), device="cpu")
    load_reference_checkpoint(ckpt["path"], model)
    out = {}
    for combine in (False, True):
        out[combine] = os.path.join(tree["root"], f"out_port_{'combined' if combine else 'stacked'}")
        timings = []
        metrics = port_infer.save_depth(model, ["scan1"], tree["data"], out[combine],
                                        combine_conf=combine, device="cpu",
                                        logger=lambda *a: None, timings=timings, **SAVE_KW)
        assert len(timings) == NV and set(timings[0]) == {"load_ms", "forward_ms", "write_ms"}
    return dict(jax=out_jax, port=out[False], port_combined=out[True], jmetrics=jmetrics,
                metrics=metrics, model=model)


def artifact(root, kind, vid, ext):
    return os.path.join(root, "scan1", kind, f"{vid:0>8}{ext}")


@pytest.mark.parametrize("vid", range(NV))
def test_save_depth_matches_jax(saved, tree, vid):
    jd, _ = read_pfm(artifact(saved["jax"], "depth_est", vid, ".pfm"))
    td, _ = read_pfm(artifact(saved["port"], "depth_est", vid, ".pfm"))
    assert td.shape == (SIZE, SIZE)
    np.testing.assert_allclose(td, jd, rtol=0, atol=DEPTH_ATOL)
    jc = np.load(artifact(saved["jax"], "confidence", vid, ".npy"))
    tc = np.load(artifact(saved["port"], "confidence", vid, ".npy"))
    assert tc.shape == jc.shape == (4, SIZE, SIZE) and tc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=0, atol=CONF_ATOL)
    # combined: the stages' mean, as the model returns it
    cc = np.load(artifact(saved["port_combined"], "confidence", vid, ".npy"))
    assert cc.shape == (SIZE, SIZE)
    np.testing.assert_allclose(cc, jc.mean(0), rtol=0, atol=CONF_ATOL)
    np.testing.assert_array_equal(
        read_pfm(artifact(saved["port_combined"], "depth_est", vid, ".pfm"))[0], td)
    jcam = read_cam_file(artifact(saved["jax"], "cams", vid, "_cam.txt"))
    tcam = read_cam_file(artifact(saved["port"], "cams", vid, "_cam.txt"))
    np.testing.assert_array_equal(tcam.stacked(), jcam.stacked())
    for k in ("depth_min", "depth_interval", "num_depth", "depth_max"):
        assert getattr(tcam, k) == getattr(jcam, k), k
    # The port's image is PNG bytes under the .jpg name: the exact pixels the
    # JAX package hands its (lossy) JPEG encoder.
    with open(artifact(saved["port"], "images", vid, ".jpg"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    ds = jax_eval.MVSEvalDataset(tree["data"], ["scan1"], nviews=NUM_VIEW, ndepths=NDEPTHS,
                                 interval_scale=1.06, max_h=SIZE, max_w=SIZE)
    ref = np.asarray(ds[vid]["imgs"][0]) * JAX_STD + JAX_MEAN
    want = np.clip(ref * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(read_image(artifact(saved["port"], "images", vid, ".jpg")), want)
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(artifact(saved["port"], "images", vid, ".jpg")),
                     cv2.COLOR_BGR2RGB), want)


def test_depth_metric_file_matches_jax(saved):
    def parse(path):
        with open(path) as f:
            return {k: float(v) for k, v in (line.split(": ") for line in f if line.strip())}

    j = parse(os.path.join(saved["jax"], "depth_metric.txt"))
    t = parse(os.path.join(saved["port"], "depth_metric.txt"))
    assert j.keys() == t.keys() and len(t) == 7
    for k in j:
        assert abs(t[k] - j[k]) <= METRIC_ATOL, (k, t[k], j[k])
        assert abs(t[k] - float(saved["metrics"][k])) <= 1e-12


FUSIONS = {"pcd": dict(thres_view=2), "dpcd": dict(dist_base=1.0, rel_diff_base=100.0),
           "gipuma": dict(disp_thresh=0.5, num_consistent=1)}


@pytest.mark.parametrize("method", list(FUSIONS))
@pytest.mark.parametrize("folder", ["port", "port_combined"], ids=["stacked", "combined"])
def test_jax_fuse_scan_on_the_ports_folder(saved, tree, tmp_path, method, folder):
    """Random weights keep few pixels at the default thresholds: these are
    looser, and the confidence threshold 0 keeps every pixel for the
    consistency check to decide."""
    scan = os.path.join(saved[folder], "scan1")
    prob = (0.0,) * 4 if folder == "port" else (0.0,)
    kw = dict(method=method, prob_threshold=prob, n_src_views=NV - 1, logger=lambda *a: None,
              **FUSIONS[method])
    pair = os.path.join(tree["data"], "scan1")
    n_jax = jax_fuse.fuse_scan(pair, scan, str(tmp_path / "jax.ply"), **kw)
    n_port = port_fuse.fuse_scan(pair, scan, str(tmp_path / "port.ply"), device="cpu", **kw)
    assert n_port == n_jax and n_port > 100, (n_port, n_jax)
    jp, jc = read_ply(str(tmp_path / "jax.ply"))
    tp, tc = read_ply(str(tmp_path / "port.ply"))
    np.testing.assert_allclose(tp, jp, rtol=0, atol=FUSE_ATOL * float(np.abs(jp).max()))
    np.testing.assert_array_equal(tc, jc)


def test_cli_runs_save_depth_and_fusion_on_the_cpu(tree, ckpt, tmp_path):
    listfile = str(tmp_path / "list.txt")
    with open(listfile, "w") as f:
        f.write("scan1\n")
    out = str(tmp_path / "out")
    port_cli.main(["--testpath", tree["data"], "--testlist", listfile, "--ckpt_dir", ckpt["run"],
                   "--torch_ckpt", ckpt["path"], "--outdir", out, "--max_h", str(SIZE),
                   "--max_w", str(SIZE), "--ndepths", str(NDEPTHS), "--num_view", str(NUM_VIEW),
                   "--device", "cpu", "--prob_threshold", "0.0", "--thres_view", "2",
                   "--dtype", "fp32"])
    points, colors = read_ply(os.path.join(out, "scan1.ply"))
    assert points.shape[0] > 100 and colors.shape == points.shape
    assert np.isfinite(points).all()
    assert os.path.exists(os.path.join(out, "depth_metric.txt"))
    for kind, ext in (("depth_est", ".pfm"), ("confidence", ".npy"), ("cams", "_cam.txt"),
                      ("images", ".jpg")):
        assert os.path.exists(os.path.join(out, "scan1", kind, f"{NV - 1:0>8}{ext}"))


@pytest.mark.parametrize("argv", [[], ["--dtype", "bf16"]], ids=["default", "bf16"])
def test_cli_serves_in_bf16(tree, ckpt, tmp_path, argv):
    """The CLI computes in bf16 by default, as the JAX test.py does: each
    saved depth and confidence is, bit for bit, `make_infer_fn` of the
    bf16 model on the same checkpoint and sample; depths are finite and
    within the sample's hypotheses, confidences in (0, 1], and the fusion
    writes a PLY of finite points."""
    out, listfile = str(tmp_path / "out"), tmp_path / "list.txt"
    listfile.write_text("scan1\n")
    port_cli.main(["--testpath", tree["data"], "--testlist", str(listfile),
                   "--ckpt_dir", ckpt["run"], "--torch_ckpt", ckpt["path"], "--outdir", out,
                   "--max_h", str(SIZE), "--max_w", str(SIZE), "--ndepths", str(NDEPTHS),
                   "--num_view", str(NUM_VIEW), "--device", "cpu", "--prob_threshold", "0.0",
                   "--thres_view", "2"] + argv)
    model = build_model(ModelConfig(**CFG), device="cpu", dtype=torch.bfloat16)
    load_reference_checkpoint(ckpt["path"], model)
    infer = port_infer.make_infer_fn(model, TMPS)
    ds = port_eval.MVSEvalDataset(tree["data"], ["scan1"], nviews=NUM_VIEW, ndepths=NDEPTHS,
                                  interval_scale=1.06, max_h=SIZE, max_w=SIZE)
    for vid in (0, NV - 1):
        batch = collate([ds[vid]])
        depth, conf, _ = infer(batch["imgs"], {k: batch["proj_matrices"][k] for k in (
            "stage1", "stage2", "stage3", "stage4")}, batch["depth_values"])
        saved_depth = read_pfm(artifact(out, "depth_est", vid, ".pfm"))[0]
        saved_conf = np.load(artifact(out, "confidence", vid, ".npy"))
        np.testing.assert_array_equal(saved_depth, depth[0].numpy())
        np.testing.assert_array_equal(saved_conf, conf[0].numpy())
        dv = batch["depth_values"][0]
        assert np.isfinite(saved_depth).all()
        assert dv.min() <= saved_depth.min() and saved_depth.max() <= dv.max()
        assert ((saved_conf > 0) & (saved_conf <= 1)).all()
    points, colors = read_ply(os.path.join(out, "scan1.ply"))
    assert points.shape[0] > 0 and np.isfinite(points).all() and colors.shape == points.shape


# The ids are the cases' names from when ROADMAP A5 refused the first two.
@pytest.mark.parametrize("argv,error,match", [
    (["--data_parallel", "2"], ValueError, "torchrun"),
    (["--view_parallel", "2"], ValueError, "torchrun"),
    (["--which_ckpt", "orbax_best"], ValueError, r"python tools/orbax_to_torch\.py"),
    (["--depth_parallel", "2"], ValueError, "torchrun"),
], ids=["argv0-ROADMAP A5", "argv1-ROADMAP A5", "argv2-ROADMAP A4", "argv3-ROADMAP A5b"])
def test_cli_refuses_what_is_not_ported(tree, ckpt, tmp_path, argv, error, match):
    """An orbax checkpoint directory is read once tools/orbax_to_torch.py has
    converted it (A4): the CLI names that command. The data, view and depth
    axes serve (A5, A5b), but one process cannot be a grid of two."""
    os.makedirs(os.path.join(ckpt["run"], "orbax_best"), exist_ok=True)  # a JAX checkpoint dir
    with pytest.raises(error, match=match):
        port_cli.main(["--testpath", tree["data"], "--ckpt_dir", ckpt["run"], "--outdir",
                       str(tmp_path), "--device", "cpu"] + argv)


def test_cli_serves_over_view_chunks(tree, ckpt, saved, tmp_path):
    """`--eval_view_chunk 2` runs the backbone over chunks of 2 of the 3
    views; every depth map is the unchunked run's within the model test's
    bound."""
    out, listfile = str(tmp_path / "out"), tmp_path / "list.txt"
    listfile.write_text("scan1\n")
    port_cli.main(["--testpath", tree["data"], "--testlist", str(listfile),
                   "--ckpt_dir", ckpt["run"], "--torch_ckpt", ckpt["path"], "--outdir", out,
                   "--max_h", str(SIZE), "--max_w", str(SIZE), "--ndepths", str(NDEPTHS),
                   "--num_view", str(NUM_VIEW), "--device", "cpu", "--skip_fusion",
                   "--eval_view_chunk", "2", "--dtype", "fp32"])
    for vid in range(NV):
        got = read_pfm(artifact(out, "depth_est", vid, ".pfm"))[0]
        want = read_pfm(artifact(saved["port"], "depth_est", vid, ".pfm"))[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_ATOL)


def test_cli_help_states_the_departures(capsys):
    with pytest.raises(SystemExit):
        port_cli.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for needle in ("--device replaces --platform", "bf16 (the default)",
                   "python tools/orbax_to_torch.py <run_dir> <out_dir>",
                   "--data_parallel defaults to -1", "no JPEG decoder", "written as PNG"):
        assert needle in text, needle


def test_a_dino_checkpoint_serves_through_the_cli(tree, tmp_path):
    """A DINOMVSNet (MVSFormer-P) `.pth` in the reference's layout, with
    DataParallel's `module.` prefix, beside configs/config_mvsformer-p.json's
    arch (ndepths 8/4/4/2): `python -m mvsformer_torch.test` loads it
    strictly and saves view 0's depth and confidence of the JAX DINOMVSNet
    that loads the same file with its own `load_reference_checkpoint`,
    within the model test's bounds."""
    from mvsformer_tpu.config import load_config as jax_load_config
    from mvsformer_torch.config import load_config, save_config
    from mvsformer_torch.models.mvsformer import random_init_

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "config_mvsformer-p.json"))
    cfg.arch.ndepths = list(CFG["ndepths"])
    model = random_init_(build_model(cfg.arch, device="cpu"), torch.Generator().manual_seed(3))
    run = str(tmp_path / "run")
    os.makedirs(run)
    path = os.path.join(run, "dino.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    save_config(cfg, os.path.join(run, "config.json"))
    listfile, out = str(tmp_path / "list.txt"), str(tmp_path / "out")
    with open(listfile, "w") as f:
        f.write("scan1\n")
    port_cli.main(["--testpath", tree["data"], "--testlist", listfile, "--ckpt_dir", run,
                   "--torch_ckpt", path, "--outdir", out, "--max_h", str(SIZE), "--max_w",
                   str(SIZE), "--ndepths", str(NDEPTHS), "--num_view", str(NUM_VIEW),
                   "--device", "cpu", "--skip_fusion", "--dtype", "fp32"])

    jcfg = jax_load_config(os.path.join(run, "config.json")).arch
    assert jcfg.model_type == "dino"
    jcfg.fused_enc_head = jcfg.fused_fpn_final = jcfg.fused_fpn_l2 = False
    params, stats = jax_load_ckpt(path, ndepths=tuple(CFG["ndepths"]), model_th=8)
    batch = collate([port_eval.MVSEvalDataset(tree["data"], ["scan1"], nviews=NUM_VIEW,
                                              ndepths=NDEPTHS, interval_scale=1.06,
                                              max_h=SIZE, max_w=SIZE)[0]])
    jmodel = jax_build_model(jcfg, dtype=jnp.float32)
    jout = jax.jit(lambda v, i, p, d: jmodel.apply(v, i, p, d, training=False, tmp=TMPS))(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["imgs"]),
        {k: jnp.asarray(batch["proj_matrices"][k]) for k in ("stage1", "stage2", "stage3",
                                                             "stage4")},
        jnp.asarray(batch["depth_values"]))
    depth = read_pfm(os.path.join(out, "scan1", "depth_est", "00000000.pfm"))[0]
    conf = np.load(os.path.join(out, "scan1", "confidence", "00000000.npy"))
    np.testing.assert_allclose(depth, np.asarray(jout["refined_depth"][0]), rtol=0,
                               atol=DEPTH_ATOL)
    np.testing.assert_allclose(conf, np.asarray(jout["photometric_confidence"][0]), rtol=0,
                               atol=CONF_ATOL)


def test_save_depth_refuses_a_mesh_and_a_model_elsewhere(tree, saved, tmp_path, monkeypatch):
    """A model laid out over view ranks that do not split the source views
    (the mesh form's check), and a model on another device."""
    from mvsformer_torch.parallel.mesh import Layout

    monkeypatch.setattr(saved["model"], "layout", Layout(view=3))
    with pytest.raises(ValueError, match="do not split over 3 view ranks"):
        port_infer.save_depth(saved["model"], ["scan1"], tree["data"], str(tmp_path),
                              device="cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="the model is on cpu"):
        port_infer.save_depth(saved["model"], ["scan1"], tree["data"], str(tmp_path),
                              device="meta")


def test_entry_points_refuse_the_default_device_without_cuda(monkeypatch, tree, ckpt, saved,
                                                             tmp_path):
    """device=None means cuda: with no card, each entry point raises rather
    than carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scan = os.path.join(saved["port"], "scan1")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_infer.save_depth(saved["model"], ["scan1"], tree["data"], str(tmp_path), **SAVE_KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fuse.fuse_scan(scan, scan, str(tmp_path / "x.ply"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli.main(["--testpath", tree["data"], "--ckpt_dir", ckpt["run"], "--outdir",
                       str(tmp_path), "--torch_ckpt", ckpt["path"]])


def test_loaded_checkpoint_is_the_bridged_state(saved, ckpt):
    sd = torch.load(ckpt["path"], weights_only=False)["state_dict"]
    got = saved["model"].state_dict()
    assert {k.removeprefix("module.") for k in sd} == set(got)
    for k, v in sd.items():
        # (the bridge gives num_batches_tracked the shape [1], the model [])
        torch.testing.assert_close(got[k.removeprefix("module.")].reshape(-1), v.reshape(-1),
                                   rtol=0, atol=0)


def test_config_json_is_read_like_the_jax_package(ckpt):
    from mvsformer_torch.config import load_config

    cfg = load_config(os.path.join(ckpt["run"], "config.json")).arch
    want = ModelConfig(**CFG)
    for f in dataclasses.fields(ModelConfig):
        if f.name != "vit_args":
            assert getattr(cfg, f.name) == getattr(want, f.name), f.name
