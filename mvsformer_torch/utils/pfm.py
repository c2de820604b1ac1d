"""PFM depth-map codec.

A copy of `mvsformer_tpu/utils/pfm.py` (the port imports nothing of the JAX
package). The Portable Float Map format used by DTU and BlendedMVS tooling:
an ASCII header (`PF` colour or `Pf` grey, the dimensions, and a scale whose
sign gives the byte order), then float32 rows stored bottom-up.
"""

from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(path: str):
    """Returns (data [H, W] or [H, W, 3] float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")

        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, dims.groups())

        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.frombuffer(f.read(), dtype=endian + "f")
        shape = (height, width, 3) if color else (height, width)
        data = data.reshape(shape)
        # PFM stores rows bottom-up.
        return np.flipud(data).astype(np.float32), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError("PFM images must be HxW, HxWx1 or HxWx3")

    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(image).astype(np.float32).tofile(f)
