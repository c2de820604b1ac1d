"""Write tests/fixtures/jpeg/: JPEG streams encoded by OpenCV and OpenCV's
decodes of them, the oracle that the port's JPEG decoder is held to where
OpenCV is not installed (the GPU machine; `chip_smoke.py` 11h).

    python tools/make_jpeg_fixtures.py

Writes, beside `manifest.json` (each stream's shape and the sha256 of its
cv2 colour decode, RGB uint8 [H, W, 3] in C order, and grey decode, uint8
[H, W]):
- small streams, one per chroma sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0), a
  4:2:0 stream 4 pixels wide (the upsampler's replication case), a grey
  stream, one with a restart interval and one with optimised Huffman
  tables, each with its cv2 decodes as PNG (`<name>.rgb.png`,
  `<name>.grey.png`);
- `view0.jpg`: view 0 of `chip_smoke.write_dtu_scan`'s scan at its full
  1600x1200 (seed 0), 4:2:0, quality 90;
- `scan/<vid>.jpg`: the 6 views of `write_dtu_scan` at `SCAN_HW` (seed 0),
  4:2:0, quality 90: the DTU-layout JPEG scan that `chip_smoke.py` serves.

Needs cv2; no file of the port imports this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from mvsformer_torch.utils.image import read_image, write_png  # noqa: E402

FIXTURES = ROOT / "tests" / "fixtures" / "jpeg"
SCAN_HW = (300, 400)
SCAN_SEED = 0
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# name: (height, width, channels, cv2.imencode parameters)
SMALL = {
    "s444": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]]),
    "s422": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"]]),
    "s440": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["440"]]),
    "s420": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]),
    "s420_w4": (9, 4, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]),
    "grey": (47, 61, 1, []),
    "restart": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"],
                            cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
    "optimised": (47, 61, 3, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["422"],
                              cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
}
QUALITY = 90


def textured(rng, h, w, c):
    """A smooth colour field with noise, uint8 [h, w, c] (RGB for c = 3)."""
    coarse = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.uint8)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR).astype(np.int16)
    img = np.clip(img + rng.integers(-24, 25, img.shape), 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., :1]


def cv2_decodes(stream: bytes):
    """(RGB [H, W, 3], grey [H, W]) as cv2.imdecode gives them."""
    buf = np.frombuffer(stream, np.uint8)
    bgr = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    return np.ascontiguousarray(bgr[..., ::-1]), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def encode(rgb: np.ndarray, params) -> bytes:
    img = rgb[..., ::-1] if rgb.shape[-1] == 3 else rgb[..., 0]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img),
                           [cv2.IMWRITE_JPEG_QUALITY, QUALITY] + list(params))
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    return buf.tobytes()


def entry(path: Path, stream: bytes, pngs: bool) -> dict:
    path.write_bytes(stream)
    rgb, grey = cv2_decodes(stream)
    out = {"jpeg": str(path.relative_to(FIXTURES)), "shape": list(grey.shape),
           "rgb_sha256": digest(rgb), "grey_sha256": digest(grey)}
    if pngs:
        stem = path.with_suffix("")
        write_png(f"{stem}.rgb.png", rgb)
        write_png(f"{stem}.grey.png", grey)
        out["rgb_png"], out["grey_png"] = f"{stem.name}.rgb.png", f"{stem.name}.grey.png"
    return out


def main() -> int:
    (FIXTURES / "scan").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    manifest = {"cv2": cv2.__version__, "quality": QUALITY, "small": {}, "scan_hw": list(SCAN_HW),
                "scan_seed": SCAN_SEED, "scan": {}}
    for name, (h, w, c, params) in SMALL.items():
        manifest["small"][name] = entry(FIXTURES / f"{name}.jpg",
                                        encode(textured(rng, h, w, c), params), pngs=True)
    with tempfile.TemporaryDirectory() as tmp:
        full = chip_smoke.write_dtu_scan(os.path.join(tmp, "full"), views=1, seed=0)
        view0 = read_image(os.path.join(full, "scan1", "images", "00000000.jpg"))
        manifest["view0"] = entry(FIXTURES / "view0.jpg",
                                  encode(view0, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                 SAMPLING["420"]]), pngs=False)
        scan = chip_smoke.write_dtu_scan(os.path.join(tmp, "scan"), img_hw=SCAN_HW,
                                         seed=SCAN_SEED)
        for v in range(chip_smoke.PIPE_VIEWS):
            img = read_image(os.path.join(scan, "scan1", "images", f"{v:0>8}.jpg"))
            manifest["scan"][f"{v:0>8}"] = entry(
                FIXTURES / "scan" / f"{v:0>8}.jpg",
                encode(img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["420"]]), pngs=False)
    with open(FIXTURES / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {FIXTURES} ({total / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
