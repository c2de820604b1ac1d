"""Write tests/fixtures/gates/: the scenes of the four accuracy gates, for
where OpenCV and JAX are not installed (the GPU machine; `chip_smoke.py`
phase 19).

    python tools/make_gate_fixtures.py

Built from the JAX tests' own functions, so they cannot drift from them:
- `<vid>.jpg`, vid 00000000-00000004: the analytic-plane gates' five
  128x128 views (tests/test_geometric_e2e.py `_render_views`), written as
  those gates write them: `cv2.imwrite` of the uint8 BGR image at JPEG
  quality 100;
- `scenes.npz`: the textures of the convergence gates' scenes
  (tests/test_convergence.py `make_scene`: rng 0 at depths 55, 70, 90 and
  105, then rng 1 at depth 75), float32. Each scene is its reference view
  and two bilinear shifts of it along x, so the texture's rows under the
  view and the columns its sources reach (`WINDOW` wide) rebuild the scene
  bit for bit (`chip_smoke.plane_scenes`); this tool checks that against
  `make_scene` before it writes, and stores a third of the bytes of the
  views themselves;
- `manifest.json`: the sha256 of each file, of each view's cv2 decode (RGB
  uint8 [H, W, 3] in C order) and of each scene's images (float32 [V, H,
  W, 3] as `make_scene` returns them), the cv2 version and the scenes'
  depths.

Needs cv2 and JAX; no file of the port imports this script.
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

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from tests import test_convergence as conv  # noqa: E402
from tests import test_geometric_e2e as geo  # noqa: E402

FIXTURES = ROOT / chip_smoke.GATE_FIXTURES


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def file_digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def textures():
    """{"rng0": [4, H, WINDOW, 3], "rng1": [1, H, WINDOW, 3]}: the
    texture windows of the convergence scenes, each checked to rebuild
    `make_scene`'s output bit for bit."""
    pad, h, w = chip_smoke.CONV_PAD, conv.H, conv.W
    out = {}
    for key, seed, depths in (("rng0", 0, chip_smoke.CONV_DEPTHS),
                              ("rng1", 1, (chip_smoke.CONV_DEPTH1,))):
        rng_tex, rng_scene = np.random.default_rng(seed), np.random.default_rng(seed)
        wins = []
        for depth in depths:
            # make_scene draws only its texture from rng: the same draws here.
            tex = conv.smooth_texture(rng_tex, h + 2 * pad, w + 2 * pad)
            win = np.ascontiguousarray(tex[pad:pad + h, pad:pad + chip_smoke.CONV_WINDOW])
            want = conv.make_scene(rng_scene, depth)
            got = chip_smoke.plane_scene(win, depth)
            for i, (g, t) in enumerate(zip(got, want)):
                for a, b in (zip(g.values(), t.values()) if isinstance(t, dict) else [(g, t)]):
                    if a.dtype != b.dtype or not np.array_equal(a, b):
                        raise RuntimeError(f"scene {key} depth {depth}: part {i} is not "
                                           f"make_scene's")
            wins.append(win)
        out[key] = np.stack(wins)
    return out


def main() -> int:
    FIXTURES.mkdir(parents=True, exist_ok=True)
    manifest = {"cv2": cv2.__version__, "quality": 100, "views": {}, "scenes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # The DTU gate's own writer; its images are the committed views.
        geo._make_plane_scan(os.path.join(tmp, "eval"))
        for v in range(chip_smoke.GATE_NV):
            name = f"{v:0>8}.jpg"
            data = Path(tmp, "eval", "scan1", "images", name).read_bytes()
            (FIXTURES / name).write_bytes(data)
            bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            manifest["views"][name] = {"sha256": file_digest(FIXTURES / name),
                                       "rgb_sha256": digest(bgr[..., ::-1])}
    tex = textures()
    np.savez(FIXTURES / "scenes.npz", **tex)
    manifest["scenes"]["file_sha256"] = file_digest(FIXTURES / "scenes.npz")
    manifest["scenes"]["depths"] = {"rng0": list(chip_smoke.CONV_DEPTHS),
                                    "rng1": [chip_smoke.CONV_DEPTH1]}
    rng0 = np.random.default_rng(0)
    manifest["scenes"]["imgs_sha256"] = {
        "rng0": [digest(conv.make_scene(rng0, d)[0]) for d in chip_smoke.CONV_DEPTHS],
        "rng1": [digest(conv.make_scene(np.random.default_rng(1), chip_smoke.CONV_DEPTH1)[0])]}
    with open(FIXTURES / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file())
    print(f"wrote {FIXTURES} ({total / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
