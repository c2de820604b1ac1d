"""Test-time dataset for DTU and Tanks-and-Temples evaluation.

Port of `mvsformer_tpu/data/eval_dataset.py`: per-scan pair.txt view
selection with source padding, intrinsics over 4 (the eval images ship at a
quarter of the cameras' resolution) with the T&T cy + 4 edge-pad shift, a
resize to max_h x max_w with per-axis intrinsic scaling, per-stage
projections (stage1..4 = K/8..K/1 of the resized input, plus a copy of
stage4 as stage5 for refine models), and the DTU ground-truth depth and mask
for the depth metrics.

Images are read by the port's own codecs (`utils/image.py`: PNG, PPM, PGM;
JPEG raises) and resized by its OpenCV-convention resizes, on the CPU.
"""

from __future__ import annotations

import os

import numpy as np

from mvsformer_torch.data.augment import normalize
from mvsformer_torch.utils.cams import read_pair_file
from mvsformer_torch.utils.image import read_image, resize_bilinear_u8, resize_nearest
from mvsformer_torch.utils.pfm import read_pfm


class MVSEvalDataset:
    def __init__(self, datapath, listfile, nviews=5, ndepths=192,
                 interval_scale=1.06, max_h=864, max_w=1152, dataset="dtu",
                 refine=True, use_short_range=False, iterative=False):
        self.datapath = datapath
        self.nviews = nviews
        self.ndepths = ndepths
        self.max_h, self.max_w = max_h, max_w
        self.dataset = dataset
        self.refine = refine
        self.use_short_range = use_short_range
        self.iterative = iterative  # stage projections for iterative inference

        if isinstance(listfile, (list, tuple)):
            scans = list(listfile)
        else:
            with open(listfile) as f:
                scans = [line.rstrip() for line in f if line.strip()]

        if isinstance(interval_scale, dict):
            self.interval_scale = interval_scale
        else:
            self.interval_scale = {s: interval_scale for s in scans}

        self.metas = []
        for scan in scans:
            pair = read_pair_file(os.path.join(self.datapath, scan, "pair.txt"))
            for ref, srcs in pair:
                if len(srcs) == 0:
                    continue
                if len(srcs) < self.nviews - 1:
                    srcs = srcs + [srcs[0]] * (self.nviews - 1 - len(srcs))
                self.metas.append((scan, ref, srcs[: self.nviews - 1]))

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path, interval_scale):
        with open(path) as f:
            lines = [line.rstrip() for line in f]
        extr = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(4, 4)
        intr = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(3, 3)
        if self.dataset == "tt":
            intr[1, 2] += 4  # the 4-pixel edge pad of the T&T images
        intr[:2, :] /= 4.0
        fields = lines[11].split()
        depth_min = float(fields[0])
        depth_interval = 2.5 if "cams_1" in path else float(fields[1])
        if len(fields) >= 3:
            depth_max = depth_min + int(float(fields[2])) * depth_interval
            depth_interval = (depth_max - depth_min) / self.ndepths
        depth_interval *= interval_scale
        return intr, extr, depth_min, depth_interval

    def _read_img(self, path):
        img = read_image(path)
        if self.dataset == "tt":
            img = np.pad(img, ((4, 4), (0, 0), (0, 0)), "edge")
        return img

    def _cam_path(self, scan, vid):
        if self.dataset == "tt":
            if self.use_short_range:
                return os.path.join(
                    self.datapath, f"short_range_cameras/cams_{scan.lower()}/{vid:0>8}_cam.txt")
            return os.path.join(self.datapath, scan, "cams", f"{vid:0>8}_cam.txt")
        p = os.path.join(self.datapath, scan, "cams_1", f"{vid:0>8}_cam.txt")
        if not os.path.exists(p):
            p = os.path.join(self.datapath, scan, "cams", f"{vid:0>8}_cam.txt")
        return p

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + list(srcs)
        imgs, projs = [], []
        depth_values = None
        gt_depth = gt_mask = None
        out_hw = (self.max_h, self.max_w)

        for i, vid in enumerate(view_ids):
            img = self._read_img(os.path.join(self.datapath, scan, "images", f"{vid:0>8}.jpg"))
            intr, extr, dmin, ditv = self._read_cam(
                self._cam_path(scan, vid), self.interval_scale[scan])

            # A direct resize to (max_h, max_w), with fx scaled by the width
            # ratio and fy by the height ratio, so a non-uniform resize stays
            # geometrically exact.
            h, w = img.shape[:2]
            intr[0, :] *= self.max_w / w
            intr[1, :] *= self.max_h / h
            img = resize_bilinear_u8(img, out_hw).numpy()

            proj = np.zeros((2, 4, 4), np.float32)
            proj[0] = extr
            proj[1, :3, :3] = intr
            projs.append(proj)
            imgs.append(normalize(img.astype(np.float32) / 255.0))

            if i == 0:
                depth_values = np.arange(
                    dmin, ditv * (self.ndepths - 0.5) + dmin, ditv, dtype=np.float32)
                if self.dataset == "dtu":
                    root = os.path.dirname(self.datapath.rstrip("/"))
                    mask_p = os.path.join(root, f"Depths_raw/{scan}/depth_visual_{vid:0>4}.png")
                    depth_p = os.path.join(root, f"Depths_raw/{scan}/depth_map_{vid:0>4}.pfm")
                    if os.path.exists(mask_p) and os.path.exists(depth_p):
                        m = read_image(mask_p, gray=True)
                        gt_mask = resize_nearest((m > 10).astype(np.float32), out_hw).numpy()
                        d = np.asarray(read_pfm(depth_p)[0], np.float32)
                        gt_depth = resize_nearest(d, out_hw).numpy()

        proj_stack = np.stack(projs)  # intrinsics are K_input / 4 here

        def scaled(f):
            p = proj_stack.copy()
            p[:, 1, :2, :] = proj_stack[:, 1, :2, :] * f
            return p

        factors = (0.25, 0.5, 1.0, 2.0, 4.0) if self.iterative else (0.5, 1.0, 2.0, 4.0, 4.0)
        proj_ms = {f"stage{i + 1}": scaled(f) for i, f in enumerate(factors[:4])}
        if self.refine:
            proj_ms["stage5"] = scaled(factors[4])

        sample = {
            "imgs": np.stack(imgs).astype(np.float32),
            "proj_matrices": proj_ms,
            "depth_values": depth_values[: self.ndepths],
            "filename": scan + "/{}/" + f"{ref:0>8}" + "{}",
        }
        if gt_depth is not None:
            sample["depth_gt"] = gt_depth
            sample["mask"] = gt_mask
        return sample
