"""The BlendedMVS training dataset.

Port of `mvsformer_tpu/data/blended.py`: the DTU pipeline of `data/dtu.py`
with BlendedMVS's layout and cameras:
`<scan>/<scan>/<scan>/{blended_images,cams,rendered_depth_maps}` with a
pair.txt per scan (references without sources are skipped), one light, the
first 7 sources shuffled in training, the mask taken from depth > 0, the
depth interval re-derived from the cam file's depth count, and resize
scales clipped to [0.375, 1] of 1536 x 2048.

`blended_images/*.jpg` go through `utils/image.read_image`, which raises on
a real JPEG stream (ROADMAP A3); PNG bytes under those names are read.
"""

from __future__ import annotations

import os

import numpy as np

from mvsformer_torch.data.dtu import DTUMVSDataset
from mvsformer_torch.utils.cams import read_pair_file


class BlendedMVSDataset(DTUMVSDataset):
    BASE_H, BASE_W = 1536, 2048
    MIN_RESIZE = 0.375

    def _build_list(self, scans):
        metas = []
        for scan in scans:
            pair_path = os.path.join(self.datapath, scan, scan, scan, "cams/pair.txt")
            metas += [(scan, 0, ref, list(srcs))
                      for ref, srcs in read_pair_file(pair_path) if srcs]
        return metas

    def file_paths(self, scan, vid, light):
        base = os.path.join(self.datapath, scan, scan, scan)
        return {
            "img": os.path.join(base, f"blended_images/{vid:0>8}.jpg"),
            "depth": os.path.join(base, f"rendered_depth_maps/{vid:0>8}.pfm"),
            "cam": os.path.join(base, f"cams/{vid:0>8}_cam.txt"),
            "mask": None,  # taken from depth > 0
        }

    def _read_mask(self, paths, depth):
        return (depth > 0).astype(np.float32)

    def _source_views(self, src_views):
        src_views = list(src_views)
        if self.mode == "train":
            src_views = src_views[:7]
            self.rng.shuffle(src_views)
        return src_views

    def _read_cam(self, path):
        return self._read_blended_cam(path)

    def _read_blended_cam(self, path):
        """-> (intrinsics, extrinsics, depth_min, depth_interval): with a
        depth count on line 11, the interval spans it over `ndepths`."""
        with open(path) as f:
            lines = [line.rstrip() for line in f]
        extr = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(4, 4)
        intr = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(3, 3)
        fields = lines[11].split()
        dmin = float(fields[0])
        ditv = float(fields[1])
        if len(fields) >= 3:
            dmax = dmin + int(float(fields[2])) * ditv
            ditv = (dmax - dmin) / self.ndepths
        ditv *= self.interval_scale
        return intr, extr, dmin, ditv
