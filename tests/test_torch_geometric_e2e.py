"""The analytic-plane accuracy gates (tests/test_geometric_e2e.py) through
the port (CPU, slow).

The JAX gates' scene (a textured plane at z = 77 seen by 5 x-translated
cameras), configuration (tests/test_model.py tiny_cfg: GN, re, drop path
0), learning rate, step count, evaluation cadence and every threshold,
unchanged. The port's side reads the scan that `chip_smoke.write_plane_scan`
(DTU layout) or `write_plane_scan_tt` (Tanks-and-Temples: the edge pad,
cy + 4, the per-scan interval, the short-range cams) writes from the
committed views, through its own `MVSEvalDataset`; trains its model in
`chip_smoke.gate_train`'s loop (torch's Adam with optax.adam's betas and
eps, `ops/losses.total_loss`), keeps a copy of the weights at the best
eval error, loads it back, and runs its `infer.save_depth` and
`fuse.fuse_scan` (pcd; dpcd for T&T) to a PLY, which is held to the
analytic surface. The JAX loop runs beside it from the same init (the JAX
init at PRNGKey(0) through the weight bridge) on the JAX gate's own scan:
the first 3 losses held within 1e-4 relative of the JAX loop's as
tests/test_torch_convergence.py says (the port's along the JAX loop, on
the JAX loop's inputs); then the two eval-error trajectories are printed
side by side, not compared, and both must reach sub-interval depth.
`chip_smoke.py` phase 19 runs the same gates on the card through the
port's checkpoint and test CLI.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_geometric_e2e.py -m slow -rA
"""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvsformer_tpu.data.eval_dataset import MVSEvalDataset as JaxEvalDataset
from mvsformer_torch.data.eval_dataset import MVSEvalDataset
from mvsformer_torch.fuse import fuse_scan
from mvsformer_torch.infer import save_depth
from mvsformer_torch.utils.ply import read_ply

import chip_smoke
from tests import test_geometric_e2e as geo
from test_torch_convergence import (along_the_jax_loop, check_first_losses, jax_gate_loop,
                                    port_model, side_by_side)
from test_torch_watchdog import watchdog

torch.set_num_threads(4)
hang_watchdog = watchdog(3000)

DITV, DEPTH = chip_smoke.GATE_DITV, chip_smoke.GATE_DEPTH
NV, EH, EW = chip_smoke.GATE_NV, chip_smoke.GATE_HW, chip_smoke.GATE_HW


def run_gate(tmp_path, kind):
    """Train the JAX loop on the JAX gate's scan and the port's on its own;
    returns (the port's model at its best weights, eval root, interval
    scale, the port's gate result)."""
    tt = kind == "tt"
    kw = dict(nviews=chip_smoke.GATE_NUM_VIEW, ndepths=chip_smoke.GATE_ND, max_h=EH, max_w=EW)
    if tt:
        kw.update(dataset="tt", use_short_range=True, interval_scale={"scan1": 1.0})
        jax_root = geo._make_plane_scan_tt(str(tmp_path / "jax" / "tteval"))
        root = chip_smoke.write_plane_scan_tt(str(tmp_path / "port" / "tteval"),
                                              chip_smoke.gate_views())
    else:
        kw.update(dataset="dtu", interval_scale=1.0)
        jax_root = geo._make_plane_scan(str(tmp_path / "jax" / "eval"))
        root = chip_smoke.write_plane_scan(str(tmp_path / "port" / "eval"),
                                           chip_smoke.gate_views())
    pad = chip_smoke.GATE_TT_PAD if tt else 0

    t0 = time.perf_counter()
    imgs, projs, dv, gt, mask = geo._collate_train_batch(JaxEvalDataset(jax_root, ["scan1"], **kw))
    if tt:
        mask = {k: v.at[:, :pad].set(0.0).at[:, -pad:].set(0.0) for k, v in mask.items()}

    def jax_err(model, p):
        out = model.apply({"params": p, "batch_stats": {}}, imgs, projs, dv, training=False,
                          tmp=[5.0, 5.0, 5.0, 1.0])
        err = jnp.abs(out["refined_depth"] - DEPTH)
        return (err * mask["stage4"]).sum() / mask["stage4"].sum()

    jres = jax_gate_loop("re", imgs, projs, dv, gt, mask, lr=chip_smoke.GATE_LR,
                         steps=chip_smoke.GATE_STEPS, eval_fn=jax_err,
                         eval_every=chip_smoke.GATE_EVAL_EVERY)
    t_jax = time.perf_counter() - t0

    batch = chip_smoke.plane_batch(torch, MVSEvalDataset(root, ["scan1"], **kw), "cpu",
                                   pad_rows=pad)
    assert abs(float(batch["dv"][0, 0]) - chip_smoke.GATE_DMIN) < 1e-4, (
        f"short-range cams not routed: the depths start at {float(batch['dv'][0, 0])}")
    model = port_model("re", jres["params"][0])
    res = chip_smoke.gate_train(torch, model, batch, chip_smoke.GATE_LR, chip_smoke.GATE_STEPS,
                                "re", eval_err=chip_smoke.plane_eval_err(torch, batch),
                                eval_every=chip_smoke.GATE_EVAL_EVERY)
    t_port = time.perf_counter() - t0 - t_jax
    jax_batch = chip_smoke.gate_batch(torch, *jax.tree.map(np.asarray, (imgs, projs, dv, gt, mask)),
                                      "cpu")
    along = along_the_jax_loop("re", jax_batch, jres, chip_smoke.GATE_LR)
    print(f"{kind} seconds: JAX loop {t_jax:.1f}, port loop {t_port:.1f}, along the JAX loop "
          f"{time.perf_counter() - t0 - t_jax - t_port:.1f}")
    side_by_side(f"{kind} eval error every {chip_smoke.GATE_EVAL_EVERY} steps", res["errors"],
                 jres["errors"])
    print(f"{kind} losses, port: {[round(x, 4) for x in res['losses']]}")
    print(f"{kind} losses, JAX:  {[round(x, 4) for x in jres['losses']]}")
    check_first_losses(res["losses"], jres["losses"], along)
    for errors in (res["errors"], jres["errors"]):
        assert np.isfinite(min(errors))
        assert min(errors) < 0.5 * DITV, (
            f"overfit never reached sub-interval depth: trajectory {errors}")

    # The best weights, not the last: a copy, loaded back.
    model.load_state_dict(res["best_state"])
    model.eval()
    again = float(chip_smoke.plane_eval_err(torch, batch)(model))
    assert again == res["best_err"], (again, res["best_err"])
    return model, root, kw["interval_scale"], res


def check_artifacts(outdir):
    for v in range(NV):
        for sub, suf in (("depth_est", ".pfm"), ("confidence", ".npy"),
                         ("cams", "_cam.txt"), ("images", ".jpg")):
            assert os.path.exists(os.path.join(outdir, "scan1", sub, f"{v:0>8}{suf}"))


def check_points(ply_path, n_points):
    assert n_points > 0.2 * NV * EH * EW, f"completeness: only {n_points} fused points"
    pts, _ = read_ply(ply_path)
    zerr = np.abs(pts[:, 2] - DEPTH)
    print(f"{n_points} points, |z - {DEPTH:g}| median {np.median(zerr):.4f}, "
          f"mean {zerr.mean():.4f}")
    assert float(np.median(zerr)) < 0.5 * DITV, (
        f"median point error {np.median(zerr):.2f} >= 0.5*interval")
    assert float(zerr.mean()) < DITV, f"mean point error {zerr.mean():.2f} >= interval {DITV}"


@pytest.mark.slow
def test_pipeline_recovers_analytic_surface(tmp_path):
    model, root, iscale, _ = run_gate(tmp_path, "dtu")
    outdir = str(tmp_path / "out")
    metrics = save_depth(model, ["scan1"], root, outdir, num_view=chip_smoke.GATE_NUM_VIEW,
                         ndepths=chip_smoke.GATE_ND, interval_scale=iscale, max_h=EH, max_w=EW,
                         dataset="dtu", device="cpu", logger=lambda *a: None)
    assert metrics is not None, "GT on disk => depth_metric protocol must run"
    assert os.path.exists(os.path.join(outdir, "depth_metric.txt"))
    print(f"depth metrics: {metrics}")
    assert metrics["abs_depth_error"] < 0.5 * DITV, metrics
    assert metrics["thres2mm_error"] < 0.25, metrics
    assert metrics["thres8mm_error"] < 0.05, metrics
    check_artifacts(outdir)

    ply_path = str(tmp_path / "fused.ply")
    n_points = fuse_scan(os.path.join(root, "scan1"), os.path.join(outdir, "scan1"), ply_path,
                         method="pcd", prob_threshold=(0.3,), thres_view=2, dist_thresh=1.0,
                         rel_diff_thresh=0.01, n_src_views=4, device="cpu",
                         logger=lambda *a: None)
    check_points(ply_path, n_points)


@pytest.mark.slow
def test_tt_dpcd_pipeline_recovers_analytic_surface(tmp_path):
    model, root, iscale, _ = run_gate(tmp_path, "tt")
    outdir = str(tmp_path / "out")
    metrics = save_depth(model, ["scan1"], root, outdir, num_view=chip_smoke.GATE_NUM_VIEW,
                         ndepths=chip_smoke.GATE_ND, interval_scale=iscale, max_h=EH, max_w=EW,
                         dataset="tt", use_short_range=True, device="cpu",
                         logger=lambda *a: None)
    assert metrics is None, "tt has no Depths_raw GT => no protocol metrics"
    check_artifacts(outdir)

    ply_path = str(tmp_path / "fused_tt.ply")
    n_points = fuse_scan(os.path.join(root, "scan1"), os.path.join(outdir, "scan1"), ply_path,
                         method="dpcd", prob_threshold=(0.3,), dist_base=2.0,
                         rel_diff_base=150.0, n_src_views=4, device="cpu",
                         logger=lambda *a: None)
    check_points(ply_path, n_points)
