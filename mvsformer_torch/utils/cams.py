"""MVSNet-style camera text files and view-pair lists.

A copy of `mvsformer_tpu/utils/cams.py`. A camera file reads::

    extrinsic
    <4x4 world-to-camera matrix, rows on lines 1-4>

    intrinsic
    <3x3 K matrix, rows on lines 7-9>

    <depth_min depth_interval [num_depth [depth_max]]>   (line 11)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CameraParams:
    extrinsic: np.ndarray  # [4, 4] world -> camera
    intrinsic: np.ndarray  # [3, 3]
    depth_min: float
    depth_interval: float
    num_depth: float | None = None
    depth_max: float | None = None

    def stacked(self) -> np.ndarray:
        """[2, 4, 4]: slot 0 the extrinsic, slot 1 K embedded in a 4x4 (the
        per-view camera layout the model and fusion read)."""
        cam = np.zeros((2, 4, 4), dtype=np.float32)
        cam[0] = self.extrinsic
        cam[1, :3, :3] = self.intrinsic
        cam[1, 3, 3] = 1.0
        return cam


def _floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.float32)


def read_cam_file(path: str, interval_scale: float = 1.0) -> CameraParams:
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsic = _floats(" ".join(lines[1:5])).reshape(4, 4)
    intrinsic = _floats(" ".join(lines[7:10])).reshape(3, 3)
    fields = lines[11].split()
    depth_min = float(fields[0])
    depth_interval = float(fields[1]) * interval_scale if len(fields) > 1 else 0.0
    num_depth = float(fields[2]) if len(fields) > 2 else None
    depth_max = float(fields[3]) if len(fields) > 3 else None
    return CameraParams(extrinsic, intrinsic, depth_min, depth_interval, num_depth, depth_max)


def write_cam_file(path: str, cam: CameraParams) -> None:
    """The layout `save_depth` writes for fusion to read back."""
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in cam.extrinsic:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in cam.intrinsic:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        tail = f"\n{cam.depth_min} {cam.depth_interval}"
        if cam.num_depth is not None:
            tail += f" {cam.num_depth}"
            if cam.depth_max is not None:
                tail += f" {cam.depth_max}"
        f.write(tail + "\n")


def read_pair_file(path: str):
    """pair.txt: the number of views, then per view a `ref` line and a
    `count id score id score ...` line. Returns [(ref, [src ids])]."""
    pairs = []
    with open(path) as f:
        num = int(f.readline())
        for _ in range(num):
            ref = int(f.readline().rstrip())
            toks = f.readline().rstrip().split()
            srcs = [int(x) for x in toks[1::2]]
            pairs.append((ref, srcs))
    return pairs
