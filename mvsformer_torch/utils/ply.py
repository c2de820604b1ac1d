"""Binary PLY point clouds: float32 x/y/z and uchar red/green/blue, little
endian. A copy of `mvsformer_tpu/utils/ply.py`."""

from __future__ import annotations

import numpy as np

_XYZ = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
_RGB = [("red", "u1"), ("green", "u1"), ("blue", "u1")]


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = list(_XYZ)
    if colors is not None:
        colors = np.asarray(colors, np.uint8).reshape(-1, 3)
        if colors.shape[0] != n:
            raise ValueError(f"{n} points but {colors.shape[0]} colours")
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += _RGB
    header.append("end_header")
    rec = np.empty(n, np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points.T
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors.T
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


def read_ply(path: str):
    """Returns (points [N, 3], colors [N, 3] or None)."""
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(tuple(line.split()[1:]))
            elif line == "end_header":
                break
        type_map = {"float": "<f4", "uchar": "u1"}
        dtype = np.dtype([(name, type_map[t]) for t, name in props])
        rec = np.fromfile(f, dtype=dtype, count=n)
    points = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
    colors = None
    if "red" in rec.dtype.names:
        colors = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
    return points, colors
