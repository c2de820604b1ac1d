"""Phase 2 of the test pipeline: fuse saved depth maps into a point cloud.

Port of `mvsformer_tpu/fuse.py`: `FusionDataset` reloads the artifacts of
`save_depth` (depth PFM, confidence npy, cam txt, reference image) per
reference view with its top sources, then `pcd` (static), `dpcd` (dynamic)
or `gipuma` (disparity-space) consistency filtering keeps pixels, and one
PLY per scan holds the kept points with the reference image's colours.

The filtering runs on `device` (`cuda` unless the caller asks for the CPU),
in fp32 with TF32 off; only the kept points and their colours come back to
the host.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from mvsformer_torch import fp32_math, resolve_device
from mvsformer_torch.ops import fusion as fusion_ops
from mvsformer_torch.utils.cams import read_cam_file, read_pair_file
from mvsformer_torch.utils.image import read_image
from mvsformer_torch.utils.pfm import read_pfm
from mvsformer_torch.utils.ply import write_ply


class FusionDataset:
    """Reloads phase-1 outputs per reference view."""

    def __init__(self, pair_folder, scan_folder, n_src_views=10):
        self.scan_folder = scan_folder
        self.pairs = [
            (ref, srcs[:n_src_views])
            for ref, srcs in read_pair_file(os.path.join(pair_folder, "pair.txt"))
            if len(srcs) > 0
        ]

    def __len__(self):
        return len(self.pairs)

    def _load_view(self, vid):
        depth, _ = read_pfm(os.path.join(self.scan_folder, "depth_est", f"{vid:0>8}.pfm"))
        conf = np.load(os.path.join(self.scan_folder, "confidence", f"{vid:0>8}.npy"))
        cam = read_cam_file(os.path.join(self.scan_folder, "cams", f"{vid:0>8}_cam.txt"))
        return depth, conf, cam.stacked()

    def __getitem__(self, idx):
        ref, srcs = self.pairs[idx]
        ref_depth, ref_conf, ref_cam = self._load_view(ref)
        img = read_image(os.path.join(self.scan_folder, "images", f"{ref:0>8}.jpg"))
        views = [self._load_view(s) for s in srcs]
        return {
            "ref_id": ref,
            "ref_depth": ref_depth,
            "ref_conf": ref_conf,
            "ref_cam": ref_cam,
            "ref_img": img,
            "src_depths": np.stack([v[0] for v in views]),
            "src_confs": np.stack([v[1] for v in views]),
            "src_cams": np.stack([v[2] for v in views]),
        }


def make_fuse_fn(method="pcd", prob_threshold=(0.5,), thres_view=5, dist_thresh=1.0,
                 rel_diff_thresh=0.01, dist_base=4.0, rel_diff_base=1300.0,
                 disp_thresh=0.1, num_consistent=2):
    """fn(ref_depth [B, H, W], src_depths [B, V, H, W], ref_cam, src_cams,
    ref_conf) -> (mask, fused depth, world points) for one fusion method."""
    prob_threshold = tuple(prob_threshold)
    if method == "pcd":
        return lambda rd, sd, rc, sc, conf: fusion_ops.fuse_pcd(
            rd, sd, rc, sc, conf, prob_threshold, dist_thresh, rel_diff_thresh, thres_view)
    if method == "gipuma":
        return lambda rd, sd, rc, sc, conf: fusion_ops.fuse_gipuma(
            rd, sd, rc, sc, conf, prob_threshold, disp_thresh, num_consistent)
    if method == "dpcd":
        return lambda rd, sd, rc, sc, conf: fusion_ops.fuse_dpcd(
            rd, sd, rc, sc, conf, prob_threshold, dist_base, rel_diff_base)
    raise ValueError(f"unknown fusion method {method!r}: pcd, dpcd or gipuma")


def fuse_view(sample, fuse_fn, prob_threshold, device):
    """One reference view of a `FusionDataset` on `device`: the source
    depths are zeroed where their own confidence fails the threshold, so
    they fail the consistency check. Returns (mask [H, W], fused [H, W],
    points [H, W, 3], the reference image [H, W, 3] uint8), on `device`."""
    def dev(x):
        return torch.as_tensor(x).to(device)

    src_depths = dev(sample["src_depths"])
    keep = fusion_ops.prob_mask(dev(sample["src_confs"]), tuple(prob_threshold))
    with fp32_math(), torch.no_grad():
        mask, fused, points = fuse_fn(
            dev(sample["ref_depth"])[None], (src_depths * keep)[None],
            dev(sample["ref_cam"])[None], dev(sample["src_cams"])[None],
            dev(sample["ref_conf"])[None])
    return mask[0], fused[0], points[0], dev(sample["ref_img"])


def fuse_scan(pair_folder, scan_folder, plyfilename, method="pcd", prob_threshold=(0.5,),
              thres_view=5, dist_thresh=1.0, rel_diff_thresh=0.01, dist_base=4.0,
              rel_diff_base=1300.0, disp_thresh=0.1, num_consistent=2, n_src_views=10,
              device=None, logger=print, timings=None):
    """Fuse one scan's depth maps into a PLY point cloud; returns the number
    of points. method: 'pcd', 'dpcd' or 'gipuma'. With a list as `timings`,
    each reference view appends its host ms of loading ("load_ms") and of
    filtering up to its kept points on the host ("fuse_ms")."""
    dev = resolve_device(device)
    ds = FusionDataset(pair_folder, scan_folder, n_src_views)
    fuse_fn = make_fuse_fn(method, prob_threshold, thres_view, dist_thresh, rel_diff_thresh,
                           dist_base, rel_diff_base, disp_thresh, num_consistent)
    all_points, all_colors = [], []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        s = ds[i]
        t1 = time.perf_counter()
        mask, _, points, img = fuse_view(s, fuse_fn, prob_threshold, dev)
        all_points.append(points[mask].cpu().numpy())
        all_colors.append(img[mask].cpu().numpy())
        kept = all_points[-1].shape[0] / mask.numel()
        t2 = time.perf_counter()
        if timings is not None:
            timings.append({"view": s["ref_id"], "load_ms": (t1 - t0) * 1e3,
                            "fuse_ms": (t2 - t1) * 1e3})
        logger(f"view {s['ref_id']:0>2}: kept {kept:.3f} of pixels")

    points = np.concatenate(all_points, axis=0)
    colors = np.concatenate(all_colors, axis=0)
    write_ply(plyfilename, points, colors)
    logger(f"saved {points.shape[0]} points to {plyfilename}")
    return points.shape[0]
